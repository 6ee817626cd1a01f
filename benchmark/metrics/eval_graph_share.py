"""The share of an evaluation call's batches that replayed a captured CUDA
graph, in percent: 100 x the program's `eval_graph_replays` counter events
over those and its `eval_eager_batches` events, both inside the window's
`eval_vae` spans (by their root id). Nothing where the program records no
such span or neither counter (a program without the graph path)."""

from harness import spans


def read(name, ctx):
    replays = spans.per_call(ctx, "eval_graph_replays", "eval_vae")
    eager = spans.per_call(ctx, "eval_eager_batches", "eval_vae")
    if replays is None or not replays + eager:
        return None
    return 100.0 * replays / (replays + eager)
