"""Weight bridge: JAX variables (numpy) <-> this port's parameters, and the
reference's ``.pth`` weights.

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
aside), and shapes must agree. ``port_variables`` is its inverse (the
``.npz`` that ``dfine_tpu.utils.checkpoint.save_params_npz`` would write).

``load_torch_checkpoint`` reads a reference (uc-vision) ``.pth`` / ``.pt``
state dict: the port's ``state_dict`` has that key layout, so after the
class-head adaptation of ``dfine_tpu/utils/checkpoint.py:98-146`` it loads
with ``load_state_dict(strict=True)``, skipping only the buffers the port
derives itself (``_SKIP_SUFFIXES`` / ``_SKIP_EXACT``, :150-156).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

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


def port_to_jax(v: np.ndarray, transform: Optional[str], conv_transpose: bool) -> np.ndarray:
    """The inverse of ``jax_to_port``."""
    if transform == "conv":
        if conv_transpose:
            return v.transpose(2, 3, 0, 1)[::-1, ::-1]
        return v.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if transform == "linear":
        return v.T
    return v


@torch.no_grad()
def port_variables(model: nn.Module, skip: Tuple[str, ...] = ()) -> Dict[str, np.ndarray]:
    """The port model's weights as flat JAX variables {"params/...",
    "batch_stats/..."} (fp32 numpy), the layout of
    ``dfine_tpu.utils.checkpoint.save_params_npz``; the tensors of the
    modules at the paths in ``skip`` left out (``infer.int8`` writes its
    int8 modules itself)."""
    flat = {}
    for key, tensor in model.state_dict().items():
        if key.endswith("num_batches_tracked") or key.rsplit(".", 1)[0] in skip:
            continue
        fkey, transform = flax_key(key, tensor.dim())
        module = model.get_submodule(key.rsplit(".", 1)[0])
        v = tensor.detach().float().cpu().numpy()
        flat[fkey] = np.ascontiguousarray(
            port_to_jax(v, transform, isinstance(module, nn.ConvTranspose2d)))
    return flat


# --------------------------------------------------------- reference .pth --

def _torch_state_dict(path: Path) -> Dict[str, torch.Tensor]:
    """A .pth/.pt state dict, unwrapped from ``ema`` / ``model`` /
    ``state_dict`` / ``module`` as the JAX importer does; ``weights_only``
    so a file cannot run pickle code."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for key in ("ema", "model", "state_dict"):
            if key in obj:
                obj = obj[key]
                break
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "module" in obj:
        obj = obj["module"]
    return dict(obj)


# COCO class index -> Objects365 class index (dfine_tpu/utils/checkpoint.py:101-107)
OBJ365_IDS = [
    0, 46, 5, 58, 114, 55, 116, 65, 21, 40, 176, 127, 249, 24, 56, 139, 92,
    78, 99, 96, 144, 295, 178, 180, 38, 39, 13, 43, 120, 219, 148, 173, 165,
    154, 137, 113, 145, 146, 204, 8, 35, 10, 88, 84, 93, 26, 112, 82, 265,
    104, 141, 152, 234, 143, 150, 97, 2, 50, 25, 75, 98, 153, 37, 73, 115,
    132, 106, 61, 163, 134, 277, 81, 133, 18, 94, 30, 169, 70, 328, 226,
]


def map_class_rows(cur: torch.Tensor, pretrain: torch.Tensor) -> torch.Tensor:
    """Class-head rows between COCO and Objects365 indexing; rows without a
    counterpart keep ``cur``."""
    if pretrain.shape == cur.shape:
        return pretrain
    out = cur.clone()
    if pretrain.shape[0] > cur.shape[0]:  # obj365 -> coco
        for coco_id, obj_id in enumerate(OBJ365_IDS):
            if coco_id < cur.shape[0]:
                out[coco_id] = pretrain[obj_id + 1]
    else:  # coco -> obj365
        for coco_id, obj_id in enumerate(OBJ365_IDS):
            if coco_id < pretrain.shape[0]:
                out[obj_id + 1] = pretrain[coco_id]
    return out


def adjust_head_parameters(sd: Dict[str, torch.Tensor],
                           current: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Score-head weights and biases row-mapped by ``map_class_rows``; a
    denoising embedding of another size dropped (the model keeps its own)."""
    sd = dict(sd)
    key = "decoder.denoising_class_embed.weight"
    if key in sd and key in current and tuple(sd[key].shape) != tuple(current[key].shape):
        del sd[key]
    head_names = ["decoder.enc_score_head.weight", "decoder.enc_score_head.bias"]
    for i in range(8):
        head_names += [f"decoder.dec_score_head.{i}.weight", f"decoder.dec_score_head.{i}.bias"]
    for name in head_names:
        if name in sd and name in current:
            sd[name] = map_class_rows(current[name], sd[name])
    return sd


# buffers the reference saves and the port derives itself
_SKIP_SUFFIXES = ("num_batches_tracked", "anchors", "valid_mask", "num_points_scale", "project")
_SKIP_EXACT = {"decoder.up", "decoder.reg_scale", "decoder.decoder.up",
               "decoder.decoder.reg_scale"}


@torch.no_grad()
def load_torch_checkpoint(model: nn.Module, path_or_sd: Union[str, Path, Dict]) -> nn.Module:
    """Fill ``model`` in place from a reference ``.pth`` / ``.pt`` (or an
    in-memory state dict): class heads adapted, the derived buffers
    skipped, then ``load_state_dict(strict=True)``: any other key left over
    or missing, or a shape that differs, raises."""
    sd = (_torch_state_dict(Path(path_or_sd)) if isinstance(path_or_sd, (str, Path))
          else dict(path_or_sd))
    sd = {k: torch.as_tensor(v) for k, v in sd.items()
          if not (k.endswith(_SKIP_SUFFIXES) or k in _SKIP_EXACT)}
    current = model.state_dict()
    sd = adjust_head_parameters(sd, current)
    for k, v in current.items():  # what the port keeps of its own
        if k not in sd and (k.endswith("num_batches_tracked")
                            or k == "decoder.denoising_class_embed.weight"):
            sd[k] = v
    model.load_state_dict(sd, strict=True)
    return model


# ------------------------------------------------------ trainer states --

STATE_FORMAT = "dfine_tpu_torch.train_state"


def state_dict_of(state, generator: Optional[torch.Generator] = None,
                  meta: Optional[Dict] = None, rank_generators: Optional[list] = None) -> Dict:
    """The whole of a ``train.train_step.TrainState`` as one dict of CPU
    tensors and plain values: model and EMA (parameters and buffers), the
    step, the optimizer's ``state_dict`` (AdamW's moments and steps, or the
    flat optimizer's, the count, the micro-step and the running mean of an
    unfinished accumulation), and the state of the
    CDN noise's generator (under data parallelism also every rank's, in
    ``rank_generators``)."""
    def cpu(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().cpu().clone()
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cpu(v) for v in tree)
        return tree

    return {
        "format": STATE_FORMAT,
        "meta": dict(meta or {}),
        "step": int(state.step),
        "model": cpu(state.model.state_dict()),
        "ema": cpu(state.ema.state_dict()),
        **cpu(state.optimizer.state_dict()),
        "generator": None if generator is None else generator.get_state().clone(),
        "rank_generators": rank_generators,
    }


def save_state(path: Union[str, Path], state, generator: Optional[torch.Generator] = None,
               meta: Optional[Dict] = None) -> int:
    """Write ``state_dict_of(...)`` to ``path`` (``torch.save``, written to
    a temporary name, then renamed); returns its bytes. In a process group
    every rank calls it: rank 0 writes, with every rank's generator state,
    and the others wait at a barrier until it has (they return 0)."""
    from ..parallel import dp as par

    path = Path(path)
    ranks = None
    if par.process_count() > 1 and generator is not None:
        ranks = par.gather_objects([generator.get_state()])
    nbytes = 0
    if par.is_main_process():
        tmp = path.with_name(path.name + ".tmp")
        torch.save(state_dict_of(state, generator, meta, ranks), tmp)
        tmp.replace(path)
        nbytes = path.stat().st_size
    par.barrier("save_state")
    return nbytes


def read_state(path: Union[str, Path]) -> Dict:
    """A trainer checkpoint of this package as saved by ``save_state``. A
    directory (the JAX package's orbax checkpoint) raises: reading it needs
    orbax, which the port does not use."""
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(
            f"{path} is a directory: a JAX trainer state (orbax); reading it needs orbax, "
            "which the port does not use. Export its weights as .npz "
            "(dfine_tpu.utils.checkpoint.save_params_npz) and load that.")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(obj, dict) and obj.get("format") == STATE_FORMAT):
        raise ValueError(f"{path} is not a trainer checkpoint of dfine_tpu_torch")
    return obj


@torch.no_grad()
def restore_state(path: Union[str, Path], state,
                  generator: Optional[torch.Generator] = None) -> Dict:
    """Fill ``state`` (and ``generator``) in place from ``save_state``'s
    file; returns the file's meta. Under data parallelism each rank takes
    its own generator state where the file holds one for its rank."""
    ck = read_state(path)
    state.model.load_state_dict(ck["model"], strict=True)
    state.ema.load_state_dict(ck["ema"], strict=True)
    state.step = ck["step"]
    state.optimizer.load_state_dict(ck)
    if generator is not None and ck["generator"] is not None:
        from ..parallel.dp import process_index

        ranks = ck.get("rank_generators") or [ck["generator"]]
        if process_index() < len(ranks):
            generator.set_state(ranks[process_index()])
    return ck["meta"]
