"""Weight bridge: JAX variables (numpy) -> this port's parameters.

``load_jax_variables`` takes the ``{"params", "batch_stats"}`` tree of a
``dfine_tpu`` model as numpy arrays and fills a port model in place. The
port's ``state_dict()`` keys are the reference (uc-vision) layout, so the
name map is an own copy of ``dfine_tpu/utils/checkpoint.py:149-205``
(reference key -> flax path), applied to each port key. Transforms:

    Conv HWIO (also grouped, depthwise)  -> OIHW
    Dense (in, out)                      -> (out, in)
    in_proj (C, 3C)                      -> in_proj_weight (3C, C)
    BN scale/bias/mean/var               -> weight/bias/running_mean/running_var
    LayerNorm scale                      -> weight
    ConvTranspose (upconv) kernel K      -> K[::-1, ::-1].transpose(2, 3, 0, 1)

flax ``nn.ConvTranspose`` (``transpose_kernel=False``) correlates the
dilated input with K unflipped, and torch ``conv_transpose2d`` with weight W
[in, out, kh, kw] equals that only for the flipped mapping above. (The JAX
side's reference importer maps this one weight with a plain
``transpose(2, 3, 1, 0)``; that swaps in and out and skips the flip, and it
loads silently because in == out == 256. It is not the inverse of this map.)

The bridge is strict both ways: every JAX leaf must be consumed, every port
parameter and buffer written (BatchNorm's ``num_batches_tracked`` counter
aside), and shapes must agree.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

_REWRITES = [
    (re.compile(r"decoder\.decoder\.layers_(\d+)"), r"decoder.decoder_layers_\1"),
    (re.compile(r"decoder\.decoder\.lqe_layers_(\d+)"), r"decoder.lqe_layers_\1"),
    (re.compile(r"decoder\.decoder\.pre_bbox_head\."), "decoder.pre_bbox_head."),
    (re.compile(r"(encoder\.encoder_\d+)\.layers_(\d+)"), r"\1_layers_\2"),
    (re.compile(r"enc_output\.proj"), "enc_output_proj"),
    (re.compile(r"enc_output\.norm"), "enc_output_norm"),
    (re.compile(r"\.cv2_0\."), ".cv2_csp."),
    (re.compile(r"\.cv2_1\."), ".cv2_conv."),
    (re.compile(r"\.cv3_0\."), ".cv3_csp."),
    (re.compile(r"\.cv3_1\."), ".cv3_conv."),
    (re.compile(r"downsample_convs_(\d+)_0\."), r"downsample_convs_\1."),
    (re.compile(r"input_proj_(\d+)_0\."), r"input_proj_\1.conv."),
    (re.compile(r"input_proj_(\d+)_1\."), r"input_proj_\1.norm."),
]


def flax_key(key: str, ndim: int) -> Tuple[str, Optional[str]]:
    """Port state_dict key -> (flat flax path, transform), transform one of
    None, "conv" (4-D weight) or "linear" (2-D weight)."""
    k = re.sub(r"\.(\d+)", r"_\1", key)  # list index -> flax name suffix
    for pat, rep in _REWRITES:
        k = pat.sub(rep, k)

    def path(stem: str) -> str:
        return stem.replace(".", "/")

    if k.endswith(".running_mean"):
        return "batch_stats/" + path(k[: -len(".running_mean")]) + "/mean", None
    if k.endswith(".running_var"):
        return "batch_stats/" + path(k[: -len(".running_var")]) + "/var", None
    if k.endswith(".in_proj_weight"):
        return "params/" + path(k[: -len(".in_proj_weight")]) + "/in_proj/kernel", "linear"
    if k.endswith(".in_proj_bias"):
        return "params/" + path(k[: -len(".in_proj_bias")]) + "/in_proj/bias", None
    if k.endswith("denoising_class_embed.weight"):
        return "params/" + path(k[: -len(".weight")]) + "/embedding", None
    if k.endswith(".weight"):
        stem = "params/" + path(k[: -len(".weight")])
        if ndim == 1:
            return stem + "/scale", None  # BatchNorm / LayerNorm weight
        return stem + "/kernel", "conv" if ndim == 4 else "linear"
    return "params/" + path(k), None


def flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def jax_to_port(v: np.ndarray, transform: Optional[str], conv_transpose: bool) -> np.ndarray:
    if transform == "conv":
        if conv_transpose:
            return v[::-1, ::-1].transpose(2, 3, 0, 1)
        return v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if transform == "linear":
        return v.T
    return v


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables_np: Dict) -> nn.Module:
    """Fill ``model`` in place from a JAX ``{"params", "batch_stats"}`` tree
    of numpy arrays (of a model initialized in train mode, so that every
    head exists). Raises on any leaf left over, any port tensor not
    written, or a shape mismatch."""
    flat = flatten(variables_np)
    used = set()
    for key, tensor in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        fkey, transform = flax_key(key, tensor.dim())
        if fkey not in flat:
            raise KeyError(f"port key {key} -> {fkey}: not in the JAX variables")
        module = model.get_submodule(key.rsplit(".", 1)[0])
        v = jax_to_port(np.asarray(flat[fkey], np.float32), transform,
                        isinstance(module, nn.ConvTranspose2d))
        if v.shape != tuple(tensor.shape):
            raise ValueError(f"{key} <- {fkey}: shape {v.shape} vs {tuple(tensor.shape)}")
        tensor.copy_(torch.from_numpy(np.ascontiguousarray(v)))
        used.add(fkey)
    unused = sorted(set(flat) - used)
    if unused:
        raise ValueError(f"{len(unused)} JAX leaves not consumed, e.g. {unused[:5]}")
    return model
