"""Passes of the fused union kernel over one panel: ceil(F / f_tile) as the
program's ``select_tiling`` chooses at the cell's shapes (a count); nothing
when it chooses the stepwise chain."""

import math


def read(ctx):
    from repro_torch.kernels.autotune import device_sm_count, select_tiling

    panel = ctx.operands.get("panel")
    if panel is None:
        return None
    bell = ctx.prog.filt.prepare_backend(ctx.prog.backend, **ctx.prog.opts).bell
    f = panel.shape[1]
    tiling = select_tiling(bell.n, f, ctx.prog.eta, bell.n_block_rows, bell.k_max,
                           bell.block_size, panel.dtype, sm_count=device_sm_count(ctx.device))
    return math.ceil(f / tiling.f_tile) if tiling.fuse else None
