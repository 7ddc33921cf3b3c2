"""Shared buffer-donation tables and the donated train step.

Mirrors ``repro/launch/donation.py``. The tables record which argument
positions of each program kind are dead on entry, relative to the
canonical step signatures:

    train:   (params, opt_state, batch)            -> params', opt_state', m
    decode:  (params, batch, cache)                -> logits, cache'
    prefill: (params, batch)                       -> logits

A train step consumes and replaces params and opt_state; a decode step
its cache (``models.lm.decode_step`` writes it in place); prefill
consumes nothing it returns.

Donation's torch meaning: the reference's XLA reuses a donated buffer for
the output instead of allocating a second copy of the model every step.
The port's donated train step does the same by hand: it updates params
and optimiser state IN PLACE (``optim.adamw_update_``), returns the very
tensors it was given, and the caller gives up the values they held.
Without donation the step is functional and leaves its inputs' values
untouched. There is no compilation: the step stays eager.
"""

from __future__ import annotations

import functools
from typing import Callable

__all__ = ["TRAIN_DONATE", "DECODE_DONATE", "PREFILL_DONATE", "jit_train_step"]

TRAIN_DONATE: tuple[int, ...] = (0, 1)
DECODE_DONATE: tuple[int, ...] = (2,)
PREFILL_DONATE: tuple[int, ...] = ()


def jit_train_step(step_fn: Callable, *, donate: bool = True) -> Callable:
    """A canonical train step of ``repro_torch.train`` (it takes
    ``donate=``) with the params/opt_state donation applied: ``donate=True``
    updates them in place, ``donate=False`` (debugging flows that keep
    the pre-step tensors) leaves them as they were."""
    return functools.partial(step_fn, donate=donate)
