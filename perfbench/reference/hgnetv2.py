"""HGNetv2 backbone (the reference's frozen copy of ``dfine_tpu_torch/models/hgnetv2.py``), NCHW."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import ConvBN, max_pool_2x2_s1, pad_rb

# stem (mid, out); per stage (mid, out, num_blocks, downsample, light_block,
# kernel, layer_num): the published B0..B6 architectures
ARCH_CONFIGS = {
    "B0": {"stem": (16, 16), "stages": [
        (16, 64, 1, False, False, 3, 3), (32, 256, 1, True, False, 3, 3),
        (64, 512, 2, True, True, 5, 3), (128, 1024, 1, True, True, 5, 3)]},
    "B1": {"stem": (24, 32), "stages": [
        (32, 64, 1, False, False, 3, 3), (48, 256, 1, True, False, 3, 3),
        (96, 512, 2, True, True, 5, 3), (192, 1024, 1, True, True, 5, 3)]},
    "B2": {"stem": (24, 32), "stages": [
        (32, 96, 1, False, False, 3, 4), (64, 384, 1, True, False, 3, 4),
        (128, 768, 3, True, True, 5, 4), (256, 1536, 1, True, True, 5, 4)]},
    "B3": {"stem": (24, 32), "stages": [
        (32, 128, 1, False, False, 3, 5), (64, 512, 1, True, False, 3, 5),
        (128, 1024, 3, True, True, 5, 5), (256, 2048, 1, True, True, 5, 5)]},
    "B4": {"stem": (32, 48), "stages": [
        (48, 128, 1, False, False, 3, 6), (96, 512, 1, True, False, 3, 6),
        (192, 1024, 3, True, True, 5, 6), (384, 2048, 1, True, True, 5, 6)]},
    "B5": {"stem": (32, 64), "stages": [
        (64, 128, 1, False, False, 3, 6), (128, 512, 2, True, False, 3, 6),
        (256, 1024, 5, True, True, 5, 6), (512, 2048, 2, True, True, 5, 6)]},
}


class LightConvBN(nn.Module):
    """1x1 (no act), then depthwise kxk (act)."""

    def __init__(self, in_ch, out_ch, kernel, use_lab=False):
        super().__init__()
        self.conv1 = ConvBN(in_ch, out_ch, 1, act=None, use_lab=use_lab)
        self.conv2 = ConvBN(out_ch, out_ch, kernel, groups=out_ch, act="relu", use_lab=use_lab)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class StemBlock(nn.Module):
    """3x3/2 -> (2x2 conv pair || 2x2 max pool) concat -> 3x3/2 -> 1x1, with
    the right/bottom pre-pads that make the reference's ceil mode exact."""

    def __init__(self, in_ch, mid_ch, out_ch, use_lab=False):
        super().__init__()
        self.stem1 = ConvBN(in_ch, mid_ch, 3, 2, use_lab=use_lab)
        self.stem2a = ConvBN(mid_ch, mid_ch // 2, 2, 1, padding=0, use_lab=use_lab)
        self.stem2b = ConvBN(mid_ch // 2, mid_ch, 2, 1, padding=0, use_lab=use_lab)
        self.stem3 = ConvBN(mid_ch * 2, mid_ch, 3, 2, use_lab=use_lab)
        self.stem4 = ConvBN(mid_ch, out_ch, 1, 1, use_lab=use_lab)

    def forward(self, x):
        x = pad_rb(self.stem1(x))
        x2 = self.stem2b(pad_rb(self.stem2a(x)))
        x1 = max_pool_2x2_s1(x)
        return self.stem4(self.stem3(torch.cat([x1, x2], 1)))


class HGBlock(nn.Module):
    """Dense-concat HG block with the "se" aggregation (1x1 squeeze, 1x1
    excitation) every published config uses."""

    def __init__(self, in_ch, mid_ch, out_ch, layer_num, kernel=3, residual=False,
                 light_block=False, use_lab=False):
        super().__init__()
        self.residual = residual
        self.layers = nn.ModuleList(
            LightConvBN(in_ch if i == 0 else mid_ch, mid_ch, kernel, use_lab) if light_block
            else ConvBN(in_ch if i == 0 else mid_ch, mid_ch, kernel, 1, use_lab=use_lab)
            for i in range(layer_num)
        )
        total = in_ch + layer_num * mid_ch
        self.aggregation = nn.Sequential(
            ConvBN(total, out_ch // 2, 1, 1, use_lab=use_lab),
            ConvBN(out_ch // 2, out_ch, 1, 1, use_lab=use_lab),
        )

    def forward(self, x):
        outs = [x]
        y = x
        for layer in self.layers:
            y = layer(y)
            outs.append(y)
        y = self.aggregation(torch.cat(outs, 1))
        return y + x if self.residual else y


class HGStage(nn.Module):
    def __init__(self, in_ch, mid_ch, out_ch, block_num, layer_num, downsample=True,
                 light_block=False, kernel=3, use_lab=False):
        super().__init__()
        self.downsample = (ConvBN(in_ch, in_ch, 3, 2, groups=in_ch, act=None, use_lab=use_lab)
                           if downsample else None)
        self.blocks = nn.Sequential(*[
            HGBlock(in_ch if i == 0 else out_ch, mid_ch, out_ch, layer_num, kernel,
                    residual=i > 0, light_block=light_block, use_lab=use_lab)
            for i in range(block_num)
        ])

    def forward(self, x):
        if self.downsample is not None:
            x = self.downsample(x)
        return self.blocks(x)


class HGNetv2(nn.Module):
    """Returns the feature maps of the stages in ``return_idx`` (strides
    4/8/16/32 for stages 0..3)."""

    def __init__(self, name: str = "B0", use_lab: bool = False,
                 return_idx: Sequence[int] = (1, 2, 3)):
        super().__init__()
        cfg = ARCH_CONFIGS[name]
        mid, out = cfg["stem"]
        self.return_idx = tuple(return_idx)
        self.stem = StemBlock(3, mid, out, use_lab)
        stages, in_ch = [], out
        for mid_ch, out_ch, nb, down, light, k, ln in cfg["stages"]:
            stages.append(HGStage(in_ch, mid_ch, out_ch, nb, ln, down, light, k, use_lab))
            in_ch = out_ch
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i in self.return_idx:
                outs.append(x)
        return outs

    @staticmethod
    def out_channels(name: str, return_idx: Sequence[int]):
        return [ARCH_CONFIGS[name]["stages"][i][1] for i in return_idx]
