"""Entries drawn independently from N(0, 1)."""

import torch


def make(shape, dtype, generator, device):
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)
