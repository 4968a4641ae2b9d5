"""Parameter-free modules honoring the engine contracts, for content
checks: decisive maps computed from the image itself.

Twin of the JAX package's test module ``tests/synthetic.py``: semantic
logits +8/-8 where the image is > 0.5 (at input * 2^(render_steps-2)
resolution), and at 1/4 resolution a Gaussian center heatmap on the
slice's foreground centroid with offsets (input-resolution units)
pointing at it. NCHW in and out.

``SyntheticBCModule`` is the boundary-contour twin: semantic logits
+8/-8 where the image is > 0.5, contour logits +8 on the foreground's
inner border (foreground pixels with a background pixel among their
eight neighbours; outside the image counts as neither), -8 elsewhere,
both at input * 2^(render_steps-2) resolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["SyntheticModule", "SyntheticBCModule"]


class SyntheticModule(nn.Module):
    num_classes = 1

    def forward(self, images, render_steps=2, interpolate_ins=False):
        x = images[:, 0]                           # (B, H, W)
        up = 2 ** (render_steps - 2)
        m = (x > 0.5).float()
        xu = m.repeat_interleave(up, dim=1).repeat_interleave(up, dim=2)
        sem_logits = (xu * 16.0 - 8.0)[:, None]

        b, h, w = x.shape
        hq, wq = h // 4, w // 4
        mq = m.reshape(b, hq, 4, wq, 4).mean(dim=(2, 4))
        yy = (torch.arange(hq, dtype=torch.float32, device=x.device)
              [None, :, None] * 4)
        xx = (torch.arange(wq, dtype=torch.float32, device=x.device)
              [None, None, :] * 4)
        total = mq.sum(dim=(1, 2), keepdim=True)
        tot = total.clamp(min=1e-6)
        cy = (mq * yy).sum(dim=(1, 2), keepdim=True) / tot
        cx = (mq * xx).sum(dim=(1, 2), keepdim=True) / tot
        has_fg = (total > 1e-3).float()
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        ctr = torch.exp(-d2 / 32.0) * has_fg       # (B, hq, wq)
        off = torch.stack([(cy - yy).expand(b, hq, wq),
                           (cx - xx).expand(b, hq, wq)], dim=1)
        return {"sem_logits": sem_logits, "ctr_hmp": ctr[:, None],
                "offsets": off}


class SyntheticBCModule(nn.Module):
    num_classes = 1

    def forward(self, images, render_steps=2, interpolate_ins=True):
        m = (images > 0.5).float()                 # (B, 1, H, W)
        eroded = -F.max_pool2d(-m, 3, stride=1, padding=1)
        up = 2 ** (render_steps - 2)
        out = {}
        for key, mask in (("sem_logits", m), ("cnt_logits", m - eroded)):
            mask = mask.repeat_interleave(up, 2).repeat_interleave(up, 3)
            out[key] = mask * 16.0 - 8.0
        return out
