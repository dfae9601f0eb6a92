"""Padded lane-steps of the streamed pass: ``waste_ratio`` of the
streaming engine's ``streaming_stats()`` (1 - requests / lane-steps run),
as a percentage. Streamed cells only."""


def read(ctx):
    st = ctx.get("streaming")
    if not st:
        return None
    return 100.0 * st["waste_ratio"]
