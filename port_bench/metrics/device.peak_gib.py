"""The device memory peak over the window:
``torch.cuda.max_memory_allocated()`` after the set-up's reset, in GiB."""


def read(ctx):
    peak = ctx.get("peak_bytes")
    return None if not peak else peak / 2**30
