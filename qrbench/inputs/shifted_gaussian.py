"""Entries drawn independently from N(0, 1), then shift·√n added to each
member's diagonal: G + shift·√n·I, n the last dimension. For shift = 4 the
singular values of a square member lie in about [2√n, 6√n], cond ≲ 3."""

import torch


def make(shape, dtype, generator, device, shift):
    a = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    a.diagonal(dim1=-2, dim2=-1).add_(shift * shape[-1] ** 0.5)
    return a
