"""Seconds of the sessions' prefill in set-up: the host clock around
``ServeEngine.open_sessions`` (every document prefilled and copied into
its row of the latent cache), ending in a synchronise."""


def read(ctx):
    return getattr(ctx, "session_prefill_s", None)
