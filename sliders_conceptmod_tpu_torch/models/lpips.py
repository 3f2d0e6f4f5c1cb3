"""LPIPS with the AlexNet backbone — counterpart of
``sliders_conceptmod_tpu/models/lpips.py``; backs ``eval/lpip_score.py``.

The ``lpips.LPIPS(net='alex')`` scorer the reference uses at 64px (Zhang et
al. 2018, as the ``lpips`` package computes it): input in [-1, 1] → the fixed
ScalingLayer → AlexNet's conv features at its five ReLU taps → unit-normalize
over channels (the eps outside the square root) → squared difference → the
learned 1×1 "lin" heads → spatial mean → sum over the taps. NCHW, fp32.

Weights come from local files (``load_lpips``): a torchvision AlexNet state
dict (``features.{0,3,6,8,10}``) and the ``lpips`` package's lin heads
(``lin<i>.model.1.weight``), each a ``.pth`` read with
``torch.load(weights_only=True)`` or a ``.safetensors`` file; torchvision and
``lpips`` are not needed.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from sliders_conceptmod_tpu_torch.io.safetensors import load_file

# lpips ScalingLayer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# AlexNet feature stages: (in_ch, out_ch, kernel, stride, pad); a max pool follows relu1 and relu2
_ALEX_CONVS = [(3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1), (384, 256, 3, 1, 1), (256, 256, 3, 1, 1)]
_POOL_AFTER = {0, 1}
ALEX_CHANNELS = [64, 192, 384, 256, 256]
TORCHVISION_CONV_INDEX = [0, 3, 6, 8, 10]  # torchvision alexnet ``.features`` indices of the convs


class AlexNetFeatures(nn.Module):
    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv2d(i, o, k, stride=s, padding=p) for i, o, k, s, p in _ALEX_CONVS)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x ``[B, 3, H, W]`` → the five ReLU taps."""
        taps, h = [], x
        for i, conv in enumerate(self.convs):
            h = F.relu(conv(h))
            taps.append(h)
            if i in _POOL_AFTER:
                h = F.max_pool2d(h, 3, 2)
        return taps


def normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """lpips ``normalize_tensor``: ``x / (sqrt(sum(x², channels)) + eps)``."""
    return x / (torch.sqrt(torch.sum(x**2, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.alex = AlexNetFeatures()
        self.lins = nn.ModuleList(nn.Conv2d(c, 1, 1, bias=False) for c in ALEX_CHANNELS)
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1), persistent=False)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """img0/img1 ``[B, 3, H, W]`` in [-1, 1] → the LPIPS distance ``[B]``."""
        taps0 = self.alex((img0 - self.shift) / self.scale)
        taps1 = self.alex((img1 - self.shift) / self.scale)
        total = torch.zeros(img0.shape[0], dtype=torch.float32, device=img0.device)
        for lin, t0, t1 in zip(self.lins, taps0, taps1):
            diff = (normalize_tensor(t0) - normalize_tensor(t1)) ** 2
            total = total + lin(diff)[:, 0].mean(dim=(1, 2))
        return total


def _load_any(path: str) -> Dict[str, torch.Tensor]:
    if str(path).endswith(".safetensors"):
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_lpips_params(alexnet_path: str, lpips_path: str) -> Dict[str, torch.Tensor]:
    """torchvision AlexNet + lpips lin heads → :class:`LPIPS`'s state dict (fp32)."""
    alex, lin = _load_any(alexnet_path), _load_any(lpips_path)
    sd = {}
    for i, ci in enumerate(TORCHVISION_CONV_INDEX):
        sd[f"alex.convs.{i}.weight"] = alex[f"features.{ci}.weight"].float()
        sd[f"alex.convs.{i}.bias"] = alex[f"features.{ci}.bias"].float()
    for i in range(len(ALEX_CHANNELS)):
        sd[f"lins.{i}.weight"] = lin[f"lin{i}.model.1.weight"].float()
    return sd


def load_lpips(alexnet_path: str, lpips_path: str, device="cuda") -> LPIPS:
    """The scorer with both weight files loaded, in eval mode on ``device``."""
    model = LPIPS()
    model.load_state_dict(load_lpips_params(alexnet_path, lpips_path))
    return model.to(device).eval()
