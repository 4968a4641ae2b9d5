"""Encoder registry: name -> module factory (the MitoNet slice's encoders)."""

from empanada_torch.models.encoders.regnet import (
    RegNet,
    regnety_200mf,
    regnety_6p4gf,
)

ENCODERS = {
    "regnety_200mf": regnety_200mf,
    "regnety_6p4gf": regnety_6p4gf,
}


def get_encoder(name: str) -> RegNet:
    if name not in ENCODERS:
        raise ValueError(f"unknown encoder {name!r}; choices: {sorted(ENCODERS)}")
    return ENCODERS[name]()
