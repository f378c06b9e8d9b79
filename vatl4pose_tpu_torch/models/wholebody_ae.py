"""WholeBodyAE, the WPU autoencoder (counterpart of vatl4pose_tpu/models/
wholebody_ae.py; AutoEncoder.py:5-39): in→24→12→7→z with ReLU, then
z→7→12→24→in with ReLU and a final sigmoid."""

from __future__ import annotations

from torch import nn

from ..device import resolve_device

__all__ = ["WholeBodyAE"]


class WholeBodyAE(nn.Module):
    def __init__(self, z_dim: int = 4, input_dim: int = 38, device=None):
        super().__init__()
        self.encoder = nn.Sequential(
            nn.Linear(input_dim, 24), nn.ReLU(True), nn.Linear(24, 12),
            nn.ReLU(True), nn.Linear(12, 7), nn.ReLU(True),
            nn.Linear(7, z_dim))
        self.decoder = nn.Sequential(
            nn.Linear(z_dim, 7), nn.ReLU(True), nn.Linear(7, 12),
            nn.ReLU(True), nn.Linear(12, 24), nn.ReLU(True),
            nn.Linear(24, input_dim), nn.Sigmoid())
        self.to(resolve_device(device))

    def forward(self, x):
        return self.decoder(self.encoder(x))
