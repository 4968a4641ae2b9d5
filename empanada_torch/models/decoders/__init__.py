from empanada_torch.models.decoders.bifpn import BiFPN, BiFPNDecoder

__all__ = ["BiFPN", "BiFPNDecoder"]
