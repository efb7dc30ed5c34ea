"""The HDCE training step's share of the card's float32 peak: model FLOPs a
sample (:mod:`port_bench.work`, three times the forward) times the samples
a second of the traced window, over 67 TFLOP/s (H100 SXM, 700 W) a card
the cell uses."""

from port_bench import work


def read(ctx):
    cfg = ctx.cfg
    fwd = work.hdce_fwd_flops_per_sample(cfg.image_hw, cfg.model.features, cfg.h_out_dim)
    peak = work.PEAK_FP32_FLOPS * int(ctx.cell["chips"])
    return 100.0 * ctx.run["samples_per_s"] * work.TRAIN_FLOPS_FACTOR * fwd / peak
