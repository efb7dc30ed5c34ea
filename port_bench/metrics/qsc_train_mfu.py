"""The quantum classifier's training step's share of the card's float32
peak: model FLOPs a sample (:mod:`port_bench.work_qsc`, three times the
forward: the front end, the circuit gate by gate and the head) times the
samples a second of the traced window, over 67 TFLOP/s (H100 SXM, 700 W) a
card the cell uses."""

from port_bench import work_qsc


def read(ctx):
    cfg = ctx.cfg
    q = cfg.quantum
    fwd = work_qsc.qsc_fwd_flops_per_sample(cfg.image_hw, q.n_qubits, q.n_layers, q.n_classes)
    peak = work_qsc.PEAK_FP32_FLOPS * int(ctx.cell["chips"])
    return 100.0 * ctx.run["samples_per_s"] * work_qsc.TRAIN_FLOPS_FACTOR * fwd / peak
