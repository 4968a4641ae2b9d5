"""Plain PyTorch references of the benchmark's two models, in float32.

MitoNet (``PanopticBiFPNPR``: RegNetY encoder, BiFPN, ladder decoder,
Panoptic-DeepLab heads, PointRend) and Panoptic-DeepLab-PointRend
(``PanopticDeepLabPR``: dilated ResNet, ASPP decoders, the same heads),
written from their published descriptions with ``torch.nn`` layers and
``torch.nn.functional`` alone. Sizes come from the configuration file;
children carry the names of the measured program's state dict, so one
state dict loads into both. ``build`` finds a configuration's
architecture in the ``ARCHS`` of the reference module that the
configuration names (``spec.load_reference``); this one by default.

Train mode (batch statistics) as the training cells run it, with
PointRend's point coordinates from the caller; and MitoNet's inference
(``MitoNet.infer``, eval mode): the semantic logits rendered by PointRend
to full resolution, the center heatmap and offsets at 1/4. Dropout (the
ASPP's) draws its mask as ``F.dropout`` on a tensor of ``mask_dtype``
from the default generator, so that a caller who seeds that generator
as the measured run did gets the same mask.

``set_precision(model, "fp8")`` is the control: the model in float8
where the measured program computes in bfloat16. Every convolution and
dense layer computes on its input and weight rounded to float8 e4m3,
its output and every batch norm's output are rounded to e4m3, and the
gradients of those outputs to e5m2, each under a per-tensor scale.
"""

from __future__ import annotations

import inspect

import torch
import torch.nn.functional as F
from torch import nn

from portbench.spec import HERE, load_reference

__all__ = ["build", "set_precision", "MitoNet", "PanopticDeepLabPR"]

BN_EPS = 1e-5
FUSION_EPS = 1e-4
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x, dtype, top):
    amax = x.abs().amax().clamp(min=1e-30)
    return (x * (top / amax)).to(dtype).float() * (amax / top)


def fake_fp8(x):
    """``x`` rounded to float8 e4m3 under a per-tensor scale, with the
    gradient of the identity."""
    return x + (_round(x.detach(), torch.float8_e4m3fn, E4M3_MAX)
                - x).detach()


class _GradFp8(torch.autograd.Function):
    """The identity, whose gradient is rounded to float8 e5m2 under a
    per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, E5M2_MAX)


def out_fp8(y):
    """An output rounded to e4m3, its gradient to e5m2."""
    return _GradFp8.apply(fake_fp8(y))


class Conv(nn.Conv2d):
    fp8 = False

    def forward(self, x):
        if self.fp8:
            return out_fp8(self._conv_forward(
                fake_fp8(x), fake_fp8(self.weight), self.bias))
        return super().forward(x)


class ConvT(nn.ConvTranspose2d):
    fp8 = False

    def forward(self, x):
        if self.fp8:
            return out_fp8(F.conv_transpose2d(
                fake_fp8(x), fake_fp8(self.weight), self.bias, self.stride))
        return F.conv_transpose2d(x, self.weight, self.bias, self.stride)


class Dense(nn.Linear):
    fp8 = False

    def forward(self, x):
        if self.fp8:
            return out_fp8(F.linear(fake_fp8(x), fake_fp8(self.weight),
                                    self.bias))
        return super().forward(x)


class BatchNorm(nn.BatchNorm2d):
    fp8 = False

    def forward(self, x):
        y = super().forward(x)
        return out_fp8(y) if self.fp8 else y


def set_precision(model, precision):
    """"fp32" (the reference) or "fp8" (the control)."""
    if precision not in ("fp32", "fp8"):
        raise ValueError(precision)
    for m in model.modules():
        if isinstance(m, (Conv, ConvT, Dense, BatchNorm)):
            m.fp8 = precision == "fp8"
    return model


def bn(c):
    return BatchNorm(c, eps=BN_EPS)


class ConvBNAct(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1, groups=1, act=F.relu):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, k, stride, (k - 1) // 2, groups=groups,
                           bias=False)
        self.BatchNorm_0 = bn(cout)
        self.act = act

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return x if self.act is None else self.act(x)


class SepConvBNAct(nn.Module):
    """Depthwise k x k, pointwise 1 x 1, batch norm, activation."""

    def __init__(self, cin, cout, k=3, act=F.relu):
        super().__init__()
        self.Conv_0 = Conv(cin, cin, k, 1, (k - 1) // 2, groups=cin,
                           bias=False)
        self.Conv_1 = Conv(cin, cout, 1, bias=False)
        self.BatchNorm_0 = bn(cout)
        self.act = act

    def forward(self, x):
        return self.act(self.BatchNorm_0(self.Conv_1(self.Conv_0(x))))


class Resample(nn.Module):
    """1 x 1 conv and batch norm where channels or stride change, else
    the identity (with no parameters)."""

    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.ConvBNAct_0 = None if (cin == cout and stride == 1) else \
            ConvBNAct(cin, cout, 1, stride, act=None)

    def forward(self, x):
        return x if self.ConvBNAct_0 is None else self.ConvBNAct_0(x)


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def down2(x):
    return F.max_pool2d(x, 3, stride=2, padding=1)


def up4(x):
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(4 * h, 4 * w), mode="bilinear",
                         align_corners=True)


# --- RegNetY -------------------------------------------------------------

class SqueezeExcite(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.Conv_0 = Conv(c, c // 4, 1)
        self.Conv_1 = Conv(c // 4, c, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.Conv_1(F.relu(self.Conv_0(s))))


class RegNetBlock(nn.Module):
    def __init__(self, cin, cout, groups, stride, se):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(cin, cout, 1)
        self.ConvBNAct_1 = ConvBNAct(cout, cout, 3, stride, groups)
        self.SqueezeExcite_0 = SqueezeExcite(cout) if se else None
        self.ConvBNAct_2 = ConvBNAct(cout, cout, 1, act=None)
        self.Resample2d_0 = Resample(cin, cout, stride)

    def forward(self, x):
        out = self.ConvBNAct_1(self.ConvBNAct_0(x))
        if self.SqueezeExcite_0 is not None:
            out = self.SqueezeExcite_0(out)
        return F.relu(self.Resample2d_0(x) + self.ConvBNAct_2(out))


class RegNet(nn.Module):
    """Stem (stride 2) and four stages (stride 2 each): the pyramid
    [stem, stage1, ..., stage4]."""

    def __init__(self, w_stem, widths, depths, groups, se):
        super().__init__()
        self.stem = ConvBNAct(1, w_stem, 3, 2)
        self.names = []
        cin = w_stem
        for i, (w, d, g) in enumerate(zip(widths, depths, groups)):
            stage = []
            for j in range(d):
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, RegNetBlock(cin, w, g, 2 if j == 0
                                                  else 1, se))
                stage.append(name)
                cin = w
            self.names.append(stage)
        self.out_channels = [w_stem] + list(widths)

    def forward(self, x):
        out = self.stem(x)
        feats = [out]
        for stage in self.names:
            for name in stage:
                out = getattr(self, name)(out)
            feats.append(out)
        return feats


# --- BiFPN ---------------------------------------------------------------

def fusion_weights(p):
    w = F.relu(p)
    return w / (w.sum() + FUSION_EPS)


class TopDown(nn.Module):
    def __init__(self, dim, chans):
        super().__init__()
        self.n = len(chans)
        self.fusion_weights = nn.Parameter(torch.ones(self.n + 1))
        self.after = SepConvBNAct(dim, dim, 3, act=F.silu)
        for i, c in enumerate(chans):
            self.add_module(f"resample_{i}", Resample(c, dim))

    def forward(self, feats):
        w = fusion_weights(self.fusion_weights)
        out = [feats[0]]
        for i in range(self.n):
            high = getattr(self, f"resample_{i}")(feats[i + 1])
            fused = (w[i] * up2(out[-1]) + w[i + 1] * high) \
                / (w[i] + w[i + 1] + FUSION_EPS)
            out.append(self.after(fused))
        return out


class BottomUp(nn.Module):
    def __init__(self, dim, chans):
        super().__init__()
        self.n = len(chans)
        self.fusion_weights = nn.Parameter(torch.ones(self.n + 1))
        self.after = SepConvBNAct(dim, dim, 3, act=F.silu)
        for i, c in enumerate(chans):
            self.add_module(f"resample_{i}", Resample(c, dim))

    def forward(self, pyramid, top_down):
        w = fusion_weights(self.fusion_weights)
        out = [top_down[0]]
        for i in range(self.n):
            pyr = getattr(self, f"resample_{i}")(pyramid[i])
            down = down2(out[-1])
            if i < self.n - 1:
                fused = (w[i] * down + w[i + 1] * pyr
                         + w[i + 2] * top_down[i + 1]) \
                    / (w[i] + w[i + 1] + w[i + 2] + FUSION_EPS)
            else:
                fused = (w[i] * down + w[i + 1] * pyr) \
                    / (w[i] + w[i + 1] + FUSION_EPS)
            out.append(self.after(fused))
        return out


class BiFPNLayer(nn.Module):
    def __init__(self, dim, chans):
        super().__init__()
        self.top_down = TopDown(dim, list(chans)[::-1][1:])
        self.bottom_up = BottomUp(dim, list(chans)[1:])

    def forward(self, pyramid):
        td = self.top_down(pyramid[::-1])
        return self.bottom_up(pyramid[1:], td[::-1])


class BiFPN(nn.Module):
    """[P3, P4, P5] -> five fused levels, largest first (P6 and P7 made
    from P5)."""

    def __init__(self, chans, dim, layers):
        super().__init__()
        self.p6_resample = Resample(chans[-1], dim)
        self.layers = layers
        chans = list(chans) + [dim, dim]
        for i in range(layers):
            self.add_module(f"layer_{i}", BiFPNLayer(dim, chans))
            chans = [dim] * len(chans)

    def forward(self, pyramid):
        p6 = down2(self.p6_resample(pyramid[-1]))
        feats = list(pyramid) + [p6, down2(p6)]
        for i in range(self.layers):
            feats = getattr(self, f"layer_{i}")(feats)
        return feats


class UpBNAct(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.ConvTranspose_0 = ConvT(cin, cout, 2, stride=2, bias=False)
        self.BatchNorm_0 = bn(cout)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.ConvTranspose_0(x)))


class BiFPNDecoder(nn.Module):
    def __init__(self, dim, scales=5):
        super().__init__()
        self.scales = scales
        for i in range(scales):
            self.add_module(f"up_{i}", UpBNAct(dim if i == 0 else 2 * dim,
                                               dim))
        self.fusion = SepConvBNAct(2 * dim, dim, 5)

    def forward(self, feats):
        x = feats[0]
        for i, skip in enumerate(feats[1:]):
            x = torch.cat([getattr(self, f"up_{i}")(x), skip], dim=1)
        return self.fusion(x)


# --- heads and PointRend --------------------------------------------------

class Head(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.SeparableConvBNAct_0 = SepConvBNAct(cin, cin, 5)
        self.Conv_0 = Conv(cin, cout, 1)

    def forward(self, x):
        return self.Conv_0(self.SeparableConvBNAct_0(x))


class PointHead(nn.Module):
    def __init__(self, classes, dim, num_fc):
        super().__init__()
        self.num_fc = num_fc
        for i in range(num_fc):
            self.add_module(f"Dense_{i}", Dense(dim + classes, dim))
        self.add_module(f"Dense_{num_fc}", Dense(dim + classes, classes))

    def forward(self, fine, coarse):
        x = torch.cat([fine, coarse], -1)
        for i in range(self.num_fc):
            x = torch.cat([F.relu(getattr(self, f"Dense_{i}")(x)), coarse],
                          -1)
        return getattr(self, f"Dense_{self.num_fc}")(x)


class PointRend(nn.Module):
    def __init__(self, classes, dim, num_fc):
        super().__init__()
        self.StandardPointHead_0 = PointHead(classes, dim, num_fc)


def point_sample(x, coords):
    """(N, C, H, W) bilinear at (N, P, 2) coordinates (x, y) in [0, 1],
    zero outside: (N, P, C)."""
    grid = (2.0 * coords - 1.0)[:, None]
    out = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out[:, :, 0].transpose(1, 2)


def train_heads(model, semantic_x, instance_x, coords):
    sem = model.semantic_head(semantic_x)
    head = model.semantic_pr.StandardPointHead_0
    points = head(point_sample(semantic_x, coords),
                  point_sample(sem, coords))
    return {"sem_logits": up4(sem), "sem_points": points,
            "point_coords": coords,
            "ctr_hmp": up4(model.ins_center(instance_x)),
            "offsets": up4(model.ins_xy(instance_x))}


class MitoNet(nn.Module):
    """PanopticBiFPNPR without an instance decoder."""

    def __init__(self, cfg):
        super().__init__()
        enc, m = cfg["encoder"], cfg["recipe"]["MODEL"]
        dim, classes = m["fpn_dim"], m["num_classes"]
        self.encoder_mod = RegNet(enc["w_stem"], enc["widths"],
                                  enc["depths"], enc["groups"], enc["se"])
        chans = self.encoder_mod.out_channels
        self.p2_resample = Resample(chans[1], dim)
        self.semantic_fpn = BiFPN(chans[2:], dim, m["fpn_layers"])
        self.semantic_decoder = BiFPNDecoder(dim)
        self.semantic_head = Head(dim, classes)
        self.ins_center = Head(dim, 1)
        self.ins_xy = Head(dim, 2)
        self.semantic_pr = PointRend(classes, dim, m["num_fc"])

    def features(self, x):
        pyramid = self.encoder_mod(x)
        pyr = [self.p2_resample(pyramid[1])] \
            + self.semantic_fpn(pyramid[2:])
        return self.semantic_decoder(pyr[::-1])

    def forward(self, x, coords):
        x = self.features(x)
        return train_heads(self, x, x, coords)

    def infer(self, x, render_steps=2, points=8192):
        """Eval mode: (sigmoid-free) semantic logits at 2^render_steps / 4
        of the input's resolution, center heatmap and offsets (dy, dx)
        at 1/4."""
        feats = self.features(x)
        coarse = self.semantic_head(feats)
        head = self.semantic_pr.StandardPointHead_0
        logits = coarse
        for _ in range(render_steps):
            logits = F.interpolate(logits, scale_factor=2, mode="bilinear",
                                   align_corners=False)
            n, c, h, w = logits.shape
            score = -logits.abs().reshape(n, h * w)
            k = min(points, h * w)
            idx = torch.sort(score, dim=1, descending=True,
                             stable=True).indices[:, :k]
            coords = torch.stack([((idx % w).float() + 0.5) / w,
                                  ((idx // w).float() + 0.5) / h], -1)
            pts = head(point_sample(feats, coords),
                       point_sample(coarse, coords))
            flat = logits.reshape(n, c, h * w).clone()
            flat.scatter_(2, idx[:, None].expand(n, c, k),
                          pts.transpose(1, 2))
            logits = flat.reshape(n, c, h, w)
        return logits, self.ins_center(feats), self.ins_xy(feats)


# --- ResNet and the Panoptic-DeepLab decoder ------------------------------

class ResNetBlock(nn.Module):
    """Bottleneck: 1 x 1, 3 x 3 (strided, dilated), 1 x 1 to 4 x planes."""

    def __init__(self, cin, planes, stride, dilation, downsample):
        super().__init__()
        out = planes * 4
        self.Conv_0 = Conv(cin, planes, 1, bias=False)
        self.BatchNorm_0 = bn(planes)
        self.Conv_1 = Conv(planes, planes, 3, stride, dilation,
                           dilation=dilation, bias=False)
        self.BatchNorm_1 = bn(planes)
        self.Conv_2 = Conv(planes, out, 1, bias=False)
        self.BatchNorm_2 = bn(out)
        self.downsample = downsample
        if downsample:
            self.Conv_3 = Conv(cin, out, 1, stride, bias=False)
            self.BatchNorm_3 = bn(out)

    def forward(self, x):
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = F.relu(self.BatchNorm_1(self.Conv_1(out)))
        out = self.BatchNorm_2(self.Conv_2(out))
        if self.downsample:
            x = self.BatchNorm_3(self.Conv_3(x))
        return F.relu(out + x)


class ResNet(nn.Module):
    """7 x 7 stem, max pool, four bottleneck stages; output stride 16
    makes stage 4 stride 1 with dilation 2."""

    def __init__(self, layers, w_stem, output_stride):
        super().__init__()
        self.stem = Conv(1, w_stem, 7, 2, 3, bias=False)
        self.BatchNorm_0 = bn(w_stem)
        strides = [1, 2, 2, 2 if output_stride == 32 else 1]
        dilations = [1, 1, 1, 1 if output_stride == 32 else 2]
        self.names = []
        cin = w_stem
        for s, (n, planes) in enumerate(zip(layers, (64, 128, 256, 512))):
            stage = []
            for b in range(n):
                stride = strides[s] if b == 0 else 1
                name = f"layer{s + 1}_block{b + 1}"
                self.add_module(name, ResNetBlock(
                    cin, planes, stride, dilations[s],
                    b == 0 and (stride != 1 or cin != planes * 4)))
                stage.append(name)
                cin = planes * 4
            self.names.append(stage)
        self.out_channels = [w_stem, 256, 512, 1024, 2048]

    def forward(self, x):
        out = F.max_pool2d(F.relu(self.BatchNorm_0(self.stem(x))), 3, 2, 1)
        feats = [out]
        for stage in self.names:
            for name in stage:
                out = getattr(self, name)(out)
            feats.append(out)
        return feats


class ASPP(nn.Module):
    def __init__(self, cin, c, rates, dropout, mask_dtype):
        super().__init__()
        n = len(rates)
        self.n, self.dropout, self.mask_dtype = n, dropout, mask_dtype
        self.Conv_0 = Conv(cin, c, 1, bias=False)
        self.BatchNorm_0 = bn(c)
        for i, r in enumerate(rates, 1):
            self.add_module(f"Conv_{i}", Conv(cin, c, 3, 1, r, dilation=r,
                                              bias=False))
            self.add_module(f"BatchNorm_{i}", bn(c))
        self.add_module(f"Conv_{n + 1}", Conv(cin, c, 1, bias=False))
        self.add_module(f"Conv_{n + 2}", Conv((n + 2) * c, c, 1, bias=False))
        self.add_module(f"BatchNorm_{n + 1}", bn(c))

    def forward(self, x):
        n = self.n
        branches = [F.relu(getattr(self, f"BatchNorm_{i}")(
            getattr(self, f"Conv_{i}")(x))) for i in range(n + 1)]
        pooled = F.relu(getattr(self, f"Conv_{n + 1}")(
            x.mean(dim=(2, 3), keepdim=True)))
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        out = F.relu(getattr(self, f"BatchNorm_{n + 1}")(
            getattr(self, f"Conv_{n + 2}")(torch.cat(branches, 1))))
        if self.dropout > 0:
            # the measured run's draw: the same call on the same shape
            mask = F.dropout(torch.ones(out.shape, dtype=self.mask_dtype,
                                        device=out.device),
                             self.dropout, training=True)
            out = out * mask.float()
        return out


class PDLDecoder(nn.Module):
    def __init__(self, chans, dim, stages, project, rates, dropout,
                 mask_dtype):
        super().__init__()
        self.ASPP_0 = ASPP(chans[-1], dim, rates, dropout, mask_dtype)
        self.stages = list(stages)
        cx = dim
        for i, (s, p) in enumerate(zip(stages, project)):
            self.add_module(f"project_{i}", ConvBNAct(chans[s], p, 1))
            self.add_module(f"fuse_{i}", SepConvBNAct(cx + p, dim, 5))
            cx = dim

    def forward(self, pyramid):
        x = self.ASPP_0(pyramid[-1])
        for i, s in enumerate(self.stages):
            low = getattr(self, f"project_{i}")(pyramid[s])
            x = F.interpolate(x, size=low.shape[-2:], mode="bilinear",
                              align_corners=True)
            x = getattr(self, f"fuse_{i}")(torch.cat([x, low], 1))
        return x


class PanopticDeepLabPR(nn.Module):
    """Panoptic-DeepLab with an instance decoder and PointRend."""

    def __init__(self, cfg, mask_dtype=torch.float32):
        super().__init__()
        enc, m = cfg["encoder"], cfg["recipe"]["MODEL"]
        dim, classes = m["decoder_channels"], m["num_classes"]
        self.encoder_mod = ResNet(enc["layers"], enc["w_stem"],
                                  m["stage4_stride"])
        chans = self.encoder_mod.out_channels
        dec = (m["low_level_stages"], m["atrous_rates"], m["aspp_dropout"],
               mask_dtype)
        proj = m["low_level_channels_project"]
        self.semantic_decoder = PDLDecoder(chans, dim, dec[0], proj,
                                           *dec[1:])
        self.instance_decoder = PDLDecoder(
            chans, dim, dec[0], [int(p * m["ins_ratio"]) for p in proj],
            *dec[1:])
        self.semantic_head = Head(dim, classes)
        self.ins_center = Head(dim, 1)
        self.ins_xy = Head(dim, 2)
        self.semantic_pr = PointRend(classes, dim, m["num_fc"])

    def forward(self, x, coords):
        pyramid = self.encoder_mod(x)
        return train_heads(self, self.semantic_decoder(pyramid),
                           self.instance_decoder(pyramid), coords)


ARCHS = {"PanopticBiFPNPR": MitoNet, "PanopticDeepLabPR": PanopticDeepLabPR}


def build(cfg, device="cpu", mask_dtype=torch.float32, base=HERE):
    """The configuration's reference model on ``device`` in train mode
    (parameters uninitialized: load a state dict): the class that the
    ``ARCHS`` of the configuration's reference module (``spec``) gives
    its architecture, with ``mask_dtype`` where the class takes one."""
    arch = cfg["recipe"]["MODEL"]["arch"]
    cls = load_reference(cfg, base).ARCHS[arch]
    kw = {"mask_dtype": mask_dtype} \
        if "mask_dtype" in inspect.signature(cls).parameters else {}
    with torch.device(device):
        model = cls(cfg, **kw)
    return model.train()
