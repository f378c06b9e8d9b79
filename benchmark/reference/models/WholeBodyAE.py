"""VATL's whole-body autoencoder for WPU: in->24->12->7->z with ReLU,
then z->7->12->24->in with ReLU and a final sigmoid."""

from __future__ import annotations

from torch import nn

from ..layers import Linear


class WholeBodyAE(nn.Module):
    def __init__(self, z_dim=4, input_dim=38):
        super().__init__()
        self.encoder = nn.Sequential(
            Linear(input_dim, 24), nn.ReLU(), Linear(24, 12), nn.ReLU(),
            Linear(12, 7), nn.ReLU(), Linear(7, z_dim))
        self.decoder = nn.Sequential(
            Linear(z_dim, 7), nn.ReLU(), Linear(7, 12), nn.ReLU(),
            Linear(12, 24), nn.ReLU(), Linear(24, input_dim), nn.Sigmoid())

    def forward(self, x):
        return self.decoder(self.encoder(x))


def build(ae_cfg, input_dim=38):
    return WholeBodyAE(ae_cfg["Z_DIM"], input_dim)
