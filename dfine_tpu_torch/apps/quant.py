"""Int8 with an accuracy gate (port of ``dfine_tpu/apps/quant.py``,
``make quant``):

    python -m dfine_tpu_torch.apps.quant [config.yaml] [key.path=value ...]

Every kernel the JAX package quantizes (each linear layer and attention
in-projection: ``infer.int8.convert_int8``) goes to int8 and the val F1 of
the int8 model, evaluated by the trainer's own eval, is held against the
fp model's: accepted when it drops by at most ``export.int8_max_drop``
(default 0.01). Where it drops more, kernels are reverted to fp in greedy
rounds, the worst relative dequantization error first, each round twice
as many as the last, until the drop fits or every kernel is fp (the nncf
behaviour). On accept it writes ``<experiment>/export_int8.npz`` in the JAX
layout (int8 kernels, fp ones for the reverted, and their ``quant``
scales), which ``Int8Model`` and the JAX package's ``Int8Model`` serve;
with every kernel reverted it writes nothing (JAX writes the fp weights,
which both ``Int8Model``s would quantize whole).
On the card; ``device="cpu"``: the plain path.
"""

from __future__ import annotations

import copy
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import cli_config
from ..infer.int8 import (Int8Linear, convert_int8, count_int8, fp_kernel, int8_kernels,
                          int8_variables, kernel_key, set_fp)
from ..train.trainer import Trainer
from .common import experiment_dir


def rank_by_quant_error(model_fp: torch.nn.Module,
                        model_int8: torch.nn.Module) -> List[Tuple[str, float]]:
    """The quantized kernels by JAX key, worst relative dequantization error
    (L2) first, computed as JAX computes it: float32 on the [in, out]
    kernels."""
    fp = int8_kernels(model_fp)
    errs = []
    for path, (owner, attr) in int8_kernels(model_int8).items():
        layer = getattr(owner, attr)
        if not isinstance(layer, Int8Linear):
            continue
        q, s, _ = (t.detach().cpu().numpy() for t in layer.int8_weight())
        deq = np.ascontiguousarray(q.T).astype(np.float32) * s[None, :]
        w = np.ascontiguousarray(fp_kernel(*fp[path])[0].detach().float().cpu().numpy().T)
        errs.append((kernel_key(path),
                     float(np.linalg.norm(deq - w) / (np.linalg.norm(w) + 1e-12))))
    return sorted(errs, key=lambda kv: -kv[1])


@torch.no_grad()
def revert_kernels(model_int8: torch.nn.Module, model_fp: torch.nn.Module,
                   names: List[str]) -> torch.nn.Module:
    """Put the fp kernels of ``model_fp`` back, in place, for the JAX keys
    ``names``: an ``nn.Linear`` (or the fp in-projection) where the
    ``Int8Linear`` was. Returns ``model_int8``."""
    fp = int8_kernels(model_fp)
    by_key = {kernel_key(path): (path, owner, attr)
              for path, (owner, attr) in int8_kernels(model_int8).items()}
    for name in names:
        path, owner, attr = by_key[name]
        set_fp(owner, attr, *fp_kernel(*fp[path]))
    return model_int8


def main(argv: Optional[List[str]] = None, device=None) -> Dict:
    cfg = cli_config(argv if argv is not None else sys.argv[1:])
    max_drop = float(cfg.export.get("int8_max_drop", 0.01))
    tr = Trainer(cfg, device=device)  # the card unless asked: raises without CUDA
    exp_dir = experiment_dir(cfg)
    tr.path_to_save = exp_dir
    tr.load_checkpoint("best")
    base = tr.evaluate("val")["f1"]

    fp = tr.eval_model()
    q = convert_int8(copy.deepcopy(fp))
    nq, nk = count_int8(q)

    def eval_f1(model):
        return tr.evaluate("val", model=model.eval())["f1"]

    f1_q = eval_f1(q)
    drop = base - f1_q
    print(f"int8 kernels: {nq}/{nk}")
    print(f"fp F1={base:.4f}  int8 F1={f1_q:.4f}  drop={drop:.4f} (max_drop={max_drop})")

    # nncf-style accuracy control: revert worst-quant-error kernels to fp in
    # exponentially growing greedy rounds until the gate passes
    reverted: List[str] = []
    rounds = []
    if drop > max_drop:
        ranking = [k for k, _ in rank_by_quant_error(fp, q)]
        batch = 1
        while drop > max_drop and len(reverted) < len(ranking):
            take = ranking[len(reverted) : len(reverted) + batch]
            reverted += take
            revert_kernels(q, fp, take)
            f1_q = eval_f1(q)
            drop = base - f1_q
            rounds.append({"reverted": len(reverted), "f1": f1_q})
            print(f"  reverted {len(reverted)}/{len(ranking)} kernels -> "
                  f"F1={f1_q:.4f} drop={drop:.4f}")
            batch *= 2

    ok = drop <= max_drop
    nq, nk = count_int8(q)
    print(f"final: {nq}/{nk} int8 kernels ({len(reverted)} reverted)  "
          f"F1={f1_q:.4f}  drop={drop:.4f}  {'ACCEPTED' if ok else 'REJECTED'}")
    out = {"fp_f1": base, "int8_f1": f1_q, "drop": drop, "accepted": ok,
           "count_int8": (nq, nk), "reverted": reverted, "rounds": rounds, "model": q}
    if ok and not nq:  # every kernel reverted: nothing to serve in int8
        print("nothing quantized: every kernel reverted to fp, no int8 artifact written")
    elif ok:
        path = exp_dir / "export_int8.npz"
        np.savez(path, **int8_variables(q))
        print(f"saved {path}")
        out["path"] = path
    return out


if __name__ == "__main__":
    main()
