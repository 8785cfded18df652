"""The train step's share of the card's peak: ``train_step_flops`` of
every step of the window over its wall and 989.4 TFLOP/s, in percent."""

from benchmark.counts.flops import PEAK_FLOPS, train_step_flops


def read(run):
    fed = run.config["fed"]
    step = train_step_flops(fed["model"], fed["model"]["img_size"], fed["data"]["batch_size"])
    return 100.0 * step * sum(r["steps"] for r in run.requests) / run.window_s / PEAK_FLOPS
