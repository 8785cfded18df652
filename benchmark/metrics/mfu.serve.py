"""The served forward's share of the card's peak: the FLOPs of the
requested tiles or patches (not padded lanes) over the window's wall and
989.4 TFLOP/s, in percent."""

from benchmark.counts.flops import PEAK_FLOPS, resunet_forward_flops


def read(run):
    model, serve = run.config["model"], run.config["serve"]
    flops = resunet_forward_flops(model, max(serve["bucket_sizes"])) * sum(r["tiles"] for r in run.requests)
    return 100.0 * flops / run.window_s / PEAK_FLOPS
