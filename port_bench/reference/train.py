"""The reference's training of the HDCE: the batch worked out again from the
benchmark's grid rows, and the first steps of Adam followed in plain
float32, with the BatchNorm running statistics the steps keep."""

from __future__ import annotations

import torch

from port_bench.reference import models
from port_bench.reference.optim import Adam


def grid_batch(rows: dict, idx: torch.Tensor, snr_db: float, geom: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The network inputs of the (S, U, B) sample indices ``idx`` at
    ``snr_db``: the noisy pilots as images (S, U, B, 2, n_sub, n_beam) and
    the noisy least-squares label (S, U, B, 2 * h_dim). The pilot noise's
    complex variance is (h_dim / pilot_num) * 10^(-SNR/10), the label's
    label_noise_factor * 10^(-SNR/10), each split over re and im."""
    def take(t):
        return torch.gather(t, 2, idx[..., None].expand(-1, -1, -1, t.shape[-1]))

    snr = torch.tensor(snr_db, dtype=torch.float32, device=idx.device)
    pilot_var = (geom["h_dim"] / geom["pilot_num"]) * 10.0 ** (-snr / 10.0)
    label_var = geom["label_noise_factor"] * 10.0 ** (-snr / 10.0)
    yp = take(rows["pilots"]) + torch.sqrt(pilot_var / 2.0) * take(rows["pilot_noise"])
    label = take(rows["h_perf"]) + torch.sqrt(label_var / 2.0) * take(rows["label_noise"])
    s, u, b = idx.shape
    img = yp.reshape(s, u, b, 2, geom["n_beam"], geom["n_sub"]).transpose(-1, -2)
    return img, label


def follow(params: dict, names: list[str], rows: dict, idxs: list[torch.Tensor], snr_db: float, geom: dict,
           lr: float) -> dict:
    """Train ``params`` (name -> tensor, copied here) for ``len(idxs)``
    steps, one batch of indices a step. Returns each step's loss, the
    first step's gradient, the parameters after the last step and the
    BatchNorm running statistics after it (``stats``). The statistics decay
    by ``0.9 ** n_users`` a step towards the batch's mean and biased
    variance."""
    p = {k: v.detach().clone() for k, v in params.items()}
    stats = {k: p[k] for k in params if k.endswith(models.RUNNING)}
    decay = 0.9 ** geom["n_users"]
    opt = Adam({k: p[k] for k in names}, lr=lr)
    losses, grad1 = [], None
    for idx in idxs:
        leaves = {k: p[k].requires_grad_(True) for k in names}
        x, y = grid_batch(rows, idx, snr_db, geom)
        batch_stats: dict = {}
        loss = models.hdce_loss(p, x, y, batch_stats)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        for k in names:
            p[k] = leaves[k].detach()
        opt.params = {k: p[k] for k in names}
        opt.step(dict(zip(names, grads)))
        for bn, (mean, var) in batch_stats.items():
            for key, batch in ((f"{bn}.running_mean", mean), (f"{bn}.running_var", var)):
                stats[key] = decay * stats[key] + (1.0 - decay) * batch
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = dict(zip(names, grads))
    return {"losses": losses, "grad1": grad1, "after": {k: p[k] for k in names}, "stats": stats}
