"""Label-consistency metrics, port of `pix2pix3d_tpu/metrics/miou.py`: mIoU
and pixel accuracy of the rendered semantics against the input masks.

The paper's semantic-alignment metric for seg configs; it needs no
pretrained weights.  The generator's argmax, the confusion matrix and the
counts stay on `opts.device`; one `[C, C]` matrix comes to the host at the
end.
"""

from __future__ import annotations

import numpy as np
import torch

from . import metric_utils


def confusion_matrix(pred, target, num_classes):
    """pred/target int `[...]` (numpy arrays, or tensors on any device) ->
    `[C, C]` counts (rows = target), of the inputs' kind."""
    idx = target.reshape(-1) * num_classes + pred.reshape(-1)
    if isinstance(idx, torch.Tensor):
        return torch.bincount(idx, minlength=num_classes ** 2) \
            .reshape(num_classes, num_classes)
    return np.bincount(np.asarray(idx), minlength=num_classes ** 2) \
        .reshape(num_classes, num_classes)


def miou_from_confusion(cm):
    inter = np.diag(cm).astype(np.float64)
    union = cm.sum(0) + cm.sum(1) - np.diag(cm)
    valid = union > 0
    return float((inter[valid] / union[valid]).mean())


@torch.no_grad()
def compute_miou(opts, num_items=500, batch_size=8):
    """Render under each dataset sample's own mask and pose (const noise,
    deterministic); compare the argmax of the rendered semantics to the
    input mask, nearest-resized to the render's resolution when they
    differ."""
    G, ds = opts.G, opts.dataset
    assert ds.data_type == "seg", "mIoU is defined for seg configs"
    num_classes = G.semantic_channels
    rng, generator = metric_utils.seeded(opts)
    cm = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=opts.device)

    done = 0
    while done < num_items:
        z, mask, pose = metric_utils.sample_inputs(opts, rng, generator, batch_size)
        out = G(z, pose, {"mask": mask, "pose": pose}, noise_mode="const", det=True)
        pred = out["semantic"].argmax(dim=-1)
        target = mask[..., 0].long()
        if pred.shape[1] != target.shape[1]:
            # nearest-resize target to the render resolution
            step = target.shape[1] / pred.shape[1]
            sel = torch.from_numpy((np.arange(pred.shape[1]) * step).astype(np.int64))
            sel = sel.to(target.device)
            target = target[:, sel][:, :, sel]
        cm += confusion_matrix(pred, target, num_classes)
        done += batch_size
    cm = cm.cpu().numpy()
    # every pixel lands in the matrix, the equal ones on its diagonal
    return {"miou": miou_from_confusion(cm),
            "pixel_acc": int(np.trace(cm)) / max(int(cm.sum()), 1)}
