"""SegNet batches drawn from the seed on the device: images uniform in
[0, 1], and labels as blocks of 16 x 16 pixels of classes drawn uniformly,
so that every class has pixels and the class weights are finite; and the
median-frequency class weights of the port's recipe over them."""

from __future__ import annotations

import torch


def make(seed: int, n: int, batch: int, height: int, width: int,
         num_classes: int, device, labels: bool = True):
    """(n, batch, H, W, 3) float32 images and (n, batch, H, W) int64 labels
    (None without ``labels``): ``n`` distinct batches, drawn in two calls."""
    g = torch.Generator(device=device).manual_seed(seed)
    images = torch.rand((n, batch, height, width, 3), generator=g,
                        device=device)
    if not labels:
        return images, None
    coarse = torch.randint(0, num_classes,
                           (n, batch, -(-height // 16), -(-width // 16)),
                           generator=g, device=device)
    lab = coarse.repeat_interleave(16, dim=2).repeat_interleave(16, dim=3)
    return images, lab[:, :, :height, :width].contiguous()


def median_frequency_weights(labels: torch.Tensor,
                             num_classes: int) -> torch.Tensor:
    """w_c = median(freq) / freq_c over the classes present, 1 for absent
    ones (Badrinarayanan et al.), as float32 on the labels' device."""
    counts = torch.bincount(labels.reshape(-1), minlength=num_classes)
    freq = counts.double() / counts.sum().clamp(min=1)
    present = freq > 0
    # numpy's median of an even count averages the two middle values
    vals = freq[present].sort().values
    k = len(vals)
    med = vals[k // 2] if k % 2 else 0.5 * (vals[k // 2 - 1] + vals[k // 2])
    return torch.where(present, med / freq.clamp(min=1e-12),
                       torch.ones_like(freq)).float()
