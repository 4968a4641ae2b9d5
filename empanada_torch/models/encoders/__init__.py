"""Encoder registry: name -> module factory (``output_stride`` 16 or
32). The same 17 names as the JAX package's registry."""

from empanada_torch.models.encoders.regnet import (
    regnetx_6p4gf,
    regnety_200mf,
    regnety_800mf,
    regnety_3p2gf,
    regnety_4gf,
    regnety_6p4gf,
    regnety_8gf,
    regnety_16gf,
)
from empanada_torch.models.encoders.resnet import (
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    resnext50_32x4d,
    resnext101_32x8d,
    wide_resnet50_2,
    wide_resnet101_2,
)

ENCODERS = {f.__name__: f for f in (
    resnet18, resnet34, resnet50, resnet101, resnet152, resnext50_32x4d,
    resnext101_32x8d, wide_resnet50_2, wide_resnet101_2, regnetx_6p4gf,
    regnety_200mf, regnety_800mf, regnety_3p2gf, regnety_4gf,
    regnety_6p4gf, regnety_8gf, regnety_16gf)}


def get_encoder(name: str, **kwargs):
    if name not in ENCODERS:
        raise ValueError(f"unknown encoder {name!r}; choices: {sorted(ENCODERS)}")
    return ENCODERS[name](**kwargs)
