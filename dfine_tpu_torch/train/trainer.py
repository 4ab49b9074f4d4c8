"""Trainer: the whole train -> eval -> checkpoint loop (port of
``dfine_tpu/train/trainer.py``).

* Setup: the config's model (the mask head for ``task: segment``) with
  weights drawn from ``train.seed``, offline pretrained weights, the
  criterion of the size (plus ``masks``), four-group AdamW with OneCycle
  (per-group peaks for l/x, ``b_accum_steps``), the freeze mask where the
  backbone asks for it, and ``make_train_step`` in bf16 autocast or fp32.
* Each step: a loader batch copied to the card (pinned, asynchronous), the
  step, and its metrics summed on the card with no host sync; they are read
  once an epoch (and every 50 steps for the log line).
* Each epoch: eval with the EMA model (``train.use_ema``) under ``no_grad``
  and the step's autocast: ``topk_decode`` of 300 with the masks of the top
  100 in bf16, the postprocess on the card, RLEs, ``Validator``; the
  decision metric (``iou`` joins it for segment), ``metrics.csv``, ``last``
  and, on improvement, ``best`` with its ``best_metric`` sidecar; early stop.
* ``train.resume`` continues from ``last`` (model, EMA, AdamW's moments and
  counts, an unfinished accumulation, the CDN generator, best_metric).
* After training, ``best`` is reloaded for the extended eval on val (with
  previews and plots) and test, and ``extended_metrics.csv``. A crash inside
  the loop is logged, kept in ``failure`` and still reaches the final eval
  where a ``best`` exists; ``main`` then raises it.

The device is the card unless the caller passes one (``device="cpu"``
runs every kernel's plain version); ``train.device`` of the shared config
is the JAX package's and is not read.

Data parallelism (``train.dp``, trainer.py:49-58, :170-189): with
``multihost.enabled`` the trainer first joins the process group
(``parallel.init_multihost``; ``apps.train`` joins it for the ranks it
spawns). DP runs when ``dp.enabled`` is set and the group has more than one
rank (with one, the log says it is off): every rank loads the same global
batch and steps on its rows with the ``axis_name="dp"`` step, SyncBN on when
``dp.sync_bn`` is ``auto`` and the per-rank batch is below 4 (``true`` /
``false`` force it). Eval batches are strided over the ranks and gathered
(trainer.py:266-308), so every rank takes the same decisions; checkpoints,
sidecars, ``metrics.csv``, ``config.yaml``, plots and previews are written
by rank 0 only, and every rank restores on resume. A crash under more than
one process re-raises instead of going on to the final eval.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..config import ConfigNode, save_config
from ..configs import model_config
from ..data.image_io import read_image
from ..data.labels import polygons_to_masks
from ..data.loader import Loader, to_device
from ..device import resolve_device
from ..eval.rle import masks_to_rle
from ..eval.validator import Validator
from ..infer.torch_model import decode
from ..models.dfine import build_model, reset_parameters
from ..models.layers import set_bn_axis
from ..ops.kernels import check_kernel_limits
from ..parallel import dp as par
from ..postprocess import postprocess_predictions
from ..utils.checkpoint import restore_state, save_state
from ..utils.logging import MetricsCSV, WandbGate, get_logger
from ..utils.profiling import device_memory_stats
from ..utils.viz import save_eval_previews
from .criterion import CriterionConfig, default_weight_dict
from .optim import OptimConfig, build_optimizer, freeze_mask
from .train_step import TrainState, make_train_step

NUM_TOP_QUERIES = 300
LOG_EVERY = 50


class Trainer:
    def __init__(self, cfg: ConfigNode, device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        t = cfg.train
        dp = t.get("dp") or {}
        mh = dp.get("multihost") or {}
        if mh.get("enabled") and par.backend() is None:
            # join the group before anything else (trainer.py:49-58)
            par.init_multihost(str(mh["coordinator_address"]), int(mh["num_processes"]),
                               int(mh["process_id"]), device=self.device)
        self.world = par.process_count()
        self.main = par.is_main_process()
        self.dp_enabled = bool(dp.get("enabled")) and self.world > 1
        self.task = cfg.task
        self.segment = cfg.task == "segment"
        # with the mask head on, box IoU joins the best-checkpoint decision metric
        self.decision_metrics = list(t.decision_metrics)
        if self.segment and "iou" not in self.decision_metrics:
            self.decision_metrics.append("iou")
        self.img_size = tuple(t.img_size)
        self.conf_thresh = t.conf_thresh
        self.keep_ratio = t.keep_ratio
        self.label_to_name = {int(k): v for k, v in t.label_to_name.items()}
        self.num_classes = 1 if t.use_one_class else len(self.label_to_name)
        self.use_ema = t.use_ema
        self.dtype = torch.bfloat16 if str(t.get("dtype", "bfloat16")) == "bfloat16" \
            else torch.float32

        self.path_to_save = Path(t.path_to_save)
        self.path_to_save.mkdir(parents=True, exist_ok=True)
        # rank 0 writes the run's files; the other ranks log to the console
        self.logger = get_logger(self.path_to_save / "train_log.txt" if self.main else None)
        self.metrics_csv = MetricsCSV(self.path_to_save / "metrics.csv")
        if self.main:
            save_config(cfg, self.path_to_save / "config.yaml")
        self.sync_bn = False
        if self.dp_enabled:
            if t.batch_size % self.world:
                raise ValueError(f"train.batch_size {t.batch_size} does not divide by the "
                                 f"{self.world} ranks")
            per_rank = t.batch_size // self.world
            sync_bn = dp.get("sync_bn", "auto")
            self.sync_bn = sync_bn is True or (sync_bn == "auto" and per_rank < 4)
            set_bn_axis(par.AXIS if self.sync_bn else None)
            self.logger.info(f"data parallelism: {self.world} ranks of {per_rank} rows, "
                             f"backend {par.backend()}, SyncBN {'on' if self.sync_bn else 'off'}")
        elif dp.get("enabled"):
            self.logger.info("train.dp.enabled with one rank: data parallelism is off")

        self.loader = Loader(Path(t.data_path), t, task=cfg.task)
        self.train_iter, self.val_iter, self.test_iter = self.loader.build_dataloaders(
            t.batch_size, t.num_workers, pin_memory=self.device.type == "cuda")
        self.logger.info(f"label stats: {self.loader.label_stats()}")
        self.logger.info(f"background images: {self.loader.background_count()}")

        model = build_model(cfg.model_name, self.num_classes, self.segment, device="cpu")
        reset_parameters(model, torch.Generator().manual_seed(int(t.seed)))
        self._load_pretrained(model)
        model = model.to(self.device)
        par.replicate(model)  # rank 0's weights on every rank
        if self.device.type == "cuda":
            check_kernel_limits(model)
        mc = model_config(cfg.model_name)
        losses = tuple(mc["criterion"]["losses"]) + (("masks",) if self.segment else ())
        self.crit_cfg = CriterionConfig(
            num_classes=self.num_classes, losses=losses, weight_dict=default_weight_dict(),
            reg_max=mc["decoder"]["reg_max"], reg_scale=mc["decoder"]["reg_scale"],
            label_smoothing=t.label_smoothing)

        self.b_accum = t.b_accum_steps
        ocfg = OptimConfig(
            base_lr=t.base_lr, backbone_lr=t.backbone_lr, betas=tuple(t.betas),
            weight_decay=t.weight_decay, clip_max_norm=t.clip_max_norm, epochs=t.epochs,
            steps_per_epoch=max(1, len(self.train_iter)), pct_start=t.cycler_pct_start,
            per_group_max_lr=cfg.model_name in ("l", "x"), b_accum_steps=self.b_accum)
        bcfg = mc["backbone"]
        freeze_stem = bcfg.get("freeze_at", -1) >= 0
        self.update_mask = (freeze_mask(model, bcfg.get("freeze_norm", False), freeze_stem)
                            if bcfg.get("freeze_norm") or freeze_stem else None)
        self.state = TrainState.create(model, build_optimizer(model, ocfg))
        step = make_train_step(self.crit_cfg, compute_dtype=self.dtype,
                               axis_name=par.AXIS if self.dp_enabled else None,
                               ema_base=t.ema_momentum, update_mask=self.update_mask)
        self.train_step = par.make_dp_train_step(step) if self.dp_enabled else step
        # the CDN noise of every step comes from this generator, on the
        # device: each rank's own under DP
        self.generator = par.rank_generator(int(t.seed) + 7, self.device)
        self.wandb = WandbGate(bool(t.use_wandb) and self.main, cfg.project_name, cfg.exp,
                               cfg.to_dict())
        self.best_metric = -1.0
        self.start_epoch = 0
        self.failure: Optional[BaseException] = None
        self._eval_ds: Dict = {}
        # host timings of this trainer's run, for callers that report them
        self.timing: Dict[str, list] = {"step_s": [], "loader_wait_s": [], "loader_busy": [],
                                        "eval": [], "checkpoint": []}
        self.plot_writer: Optional[str] = None  # "matplotlib" or "csv", after the final eval

    def _load_pretrained(self, model) -> None:
        spec = self.cfg.train.get("pretrained_model_path")
        if not spec:
            return
        from ..utils.pretrained import load_pretrained, resolve_pretrained

        resolved = resolve_pretrained(str(spec), self.cfg.model_name, logger=self.logger)
        if resolved is None:
            self.logger.info(f"pretrained weights unavailable for {spec!r}; training from "
                             "random init")
            return
        load_pretrained(resolved, model, logger=self.logger)
        self.logger.info(f"loaded pretrained weights from {resolved}")

    # -------------------------------------------------------------- eval --

    def eval_model(self) -> torch.nn.Module:
        """The model evaluated and served: the EMA copy, or the trained
        model without EMA; in eval mode."""
        return (self.state.ema if self.use_ema else self.state.model).eval()

    @torch.no_grad()
    def decode(self, images: torch.Tensor,
               model: Optional[torch.nn.Module] = None) -> Dict[str, torch.Tensor]:
        """images [B, 3, H, W] on the device (uint8 or float) -> top-300
        decode, the top 100 masks in bf16, under the step's autocast; by
        ``model`` where given (``apps.quant``'s int8 models), else by
        ``eval_model()``."""
        with torch.autocast(self.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            return decode(model if model is not None else self.eval_model(), images,
                          NUM_TOP_QUERIES)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def evaluate(self, split: str = "val", extended: bool = False,
                 save_previews: bool = False,
                 model: Optional[torch.nn.Module] = None) -> Dict:
        """Metrics of ``model`` (default: ``eval_model()``) on ``split``. With
        more than one process, batch ``bi`` is evaluated by process ``bi %
        world`` and the results are gathered, in image order, on every
        process (trainer.py:266-308)."""
        # one dataset per split, so that its RAM cache lives across evals
        if split not in self._eval_ds:
            self._eval_ds[split] = self.loader.dataset(split, mode="val")
        ds = self._eval_ds[split]
        bs = self.cfg.train.batch_size
        preds_all: List = []
        gts_all: List = []
        n = len(ds)
        pid, pc = par.process_index(), self.world
        times = {"images": 0, "load_s": 0.0, "device_s": 0.0, "tail_s": 0.0}  # this process's

        def tail(p, g):
            gt_entry = {"labels": g["labels"], "boxes": g["boxes_abs"]}
            if self.segment and g.get("polygons") is not None:
                gt_entry["masks_rle"] = masks_to_rle(polygons_to_masks(g["polygons"],
                                                                       *g["orig_size"]))
            if "masks" in p:
                p["masks_rle"] = masks_to_rle(p.pop("masks"))
            return p, gt_entry

        workers = max(2, int(self.cfg.train.get("num_workers", 8)))
        with cf.ThreadPoolExecutor(workers) as pool:
            for bi, start in enumerate(range(0, n, bs)):
                if bi % pc != pid:
                    continue
                t0 = time.perf_counter()
                ids = list(range(start, min(start + bs, n)))
                times["images"] += len(ids)
                samples, gts = zip(*pool.map(ds.load_for_eval, ids))
                images = torch.from_numpy(np.stack([s["image"] for s in samples], 0))
                if bi and bi % 50 == 0:
                    self.logger.info(f"eval[{split}] batch {bi}/{(n + bs - 1) // bs}")
                t1 = time.perf_counter()
                x = images.to(self.device).permute(0, 3, 1, 2)
                decoded = self.decode(x, model)
                self._sync()
                t2 = time.perf_counter()
                preds = postprocess_predictions(decoded, self.img_size,
                                                [g["orig_size"] for g in gts], self.conf_thresh,
                                                self.keep_ratio)
                for i, (p, gt_entry) in enumerate(pool.map(tail, preds, gts)):
                    preds_all.append((ids[i], p))
                    gts_all.append((ids[i], gt_entry))
                    if save_previews and start == 0 and self.main:
                        img_path, _ = ds._paths(ids[i])
                        save_eval_previews(Path(self.cfg.train.eval_preds_path),
                                           Path(img_path).stem, read_image(img_path), p,
                                           gt_entry, self.label_to_name)
                t3 = time.perf_counter()
                times["load_s"] += t1 - t0
                times["device_s"] += t2 - t1
                times["tail_s"] += t3 - t2
        t4 = time.perf_counter()
        if pc > 1:
            preds_all, gts_all = par.gather_objects(preds_all), par.gather_objects(gts_all)
        preds_all = [p for _, p in sorted(preds_all, key=lambda e: e[0])]
        gts_all = [g for _, g in sorted(gts_all, key=lambda e: e[0])]
        v = Validator(gts_all, preds_all, self.label_to_name, conf_thresh=self.conf_thresh,
                      iou_thresh=self.cfg.train.iou_thresh,
                      mask_batch_size=self.cfg.train.mask_batch_size)
        metrics = v.compute_metrics(extended=extended)
        times["tail_s"] += time.perf_counter() - t4
        self.timing["eval"].append({"split": split, "extended": extended, **times})
        self._last_validator = v
        return metrics

    # -------------------------------------------------------------- train --

    def train(self) -> Dict:
        """Run the loop; on a failure or an interrupt still evaluate the
        best checkpoint, where one was written (the exception stays in
        ``self.failure``)."""
        try:
            self._train_epochs()
        except KeyboardInterrupt as e:
            self.failure = e
            self.logger.warning("interrupted: evaluating the best checkpoint")
        except Exception as e:  # a train crash must not lose the experiment
            self.failure = e
            self.logger.exception(f"training failed: {e}")
            if self.world > 1:
                # a rank that went on would call collectives out of step
                # with its peers (trainer.py:335-341): fail the whole job
                raise
        if not (self.path_to_save / "best.ckpt").exists():
            # the run ended before its first eval: there is no best to evaluate
            self.logger.error(f"no best.ckpt in {self.path_to_save}: the final eval is skipped")
            return {}
        return self._final_eval()

    def _train_epochs(self) -> None:
        t = self.cfg.train
        epochs = t.epochs
        early_stop = t.early_stopping
        stale = 0
        steps_per_epoch = len(self.train_iter)
        if t.get("resume"):
            self.load_checkpoint("last")
            self.start_epoch = self.state.step // max(1, steps_per_epoch)
            self.logger.info(f"resumed from last.ckpt at epoch {self.start_epoch}")
        self.logger.info(
            f"training {self.cfg.model_name} ({self.num_classes} classes, task={self.task}) "
            f"for {epochs} epochs x {steps_per_epoch} steps on {self.device}")
        for epoch in range(self.start_epoch, epochs):
            self.train_iter.set_epoch(epoch)
            t0 = time.time()
            agg: Optional[Dict[str, torch.Tensor]] = None
            count = 0
            batches = iter(self.train_iter)
            while True:
                tw = time.perf_counter()
                batch = next(batches, None)
                ts = time.perf_counter()
                if batch is None:
                    break
                _, metrics = self.train_step(self.state, self._to_device(batch),
                                             generator=self.generator)
                # summed on the device (no host sync); read once an epoch
                agg = metrics if agg is None else {k: agg[k] + v for k, v in metrics.items()}
                count += 1
                # host seconds waiting for the loader, then in the step (the
                # step's matching waits for its forward on the card), and
                # whether the loader was still making this epoch's batches
                self.timing["loader_wait_s"].append(ts - tw)
                self.timing["step_s"].append(time.perf_counter() - ts)
                self.timing["loader_busy"].append(self.train_iter.producing)
                if count % LOG_EVERY == 0 or count == steps_per_epoch:
                    eta = (time.time() - t0) / count * (steps_per_epoch - count)
                    self.logger.info(f"epoch {epoch} [{count}/{steps_per_epoch}] "
                                     f"loss={float(metrics['loss']):.3f} eta={eta:.0f}s")
            mean = {k: float(v) / max(1, count) for k, v in (agg or {}).items()}
            dur = time.time() - t0
            if epoch == self.start_epoch:
                for s in device_memory_stats():
                    self.logger.info(f"device memory: {s}")
            self.logger.info(f"epoch {epoch}: train done ({dur:.0f}s), evaluating")
            metrics = self.evaluate("val")
            decision = float(np.mean([metrics[k] for k in self.decision_metrics if k in metrics]))
            decision = par.broadcast_scalar(decision)  # every rank decides as rank 0
            row = {"epoch": epoch, "train_time_s": round(dur, 1),
                   "loss": mean.get("loss", 0.0), "decision": decision}
            row.update({k: v for k, v in metrics.items() if not isinstance(v, dict)})
            if self.main:
                self.metrics_csv.log(row)
            self.wandb.log({f"val/{k}": v for k, v in row.items()}, step=epoch)
            self.wandb.watch(self.state.model, grad_norm=mean.get("grad_norm"), step=epoch)
            self.logger.info(
                f"epoch {epoch}: f1={metrics['f1']:.4f} mAP50={metrics.get('mAP_50', 0):.4f} "
                f"decision={decision:.4f} ({dur:.0f}s)")
            improved = decision > self.best_metric
            if improved:
                self.best_metric = decision
            self.save_checkpoint("last")
            if improved:  # best is this epoch's last
                t0 = time.perf_counter()
                best = self.path_to_save / "best.ckpt"
                if self.main:
                    shutil.copyfile(self.path_to_save / "last.ckpt", best)
                self._checkpoint_written("best", best.stat().st_size if self.main else 0, t0)
                stale = 0
            else:
                stale += 1
            if early_stop and stale >= early_stop:
                self.logger.info(f"early stopping at epoch {epoch}")
                break

    def _final_eval(self) -> Dict:
        self.logger.info("final eval: loading best checkpoint")
        self.load_checkpoint("best")
        self.logger.info("final eval: running extended val eval")
        final = {"val": self.evaluate("val", extended=True, save_previews=True)}
        if self.main:
            self.plot_writer = self._last_validator.save_plots(self.path_to_save / "plots",
                                                               logger=self.logger)
        if self.loader.splits["test"]:
            final["test"] = self.evaluate("test", extended=True)
        ext_csv = MetricsCSV(self.path_to_save / "extended_metrics.csv")
        for split, m in final.items():
            ext = m.pop("extended_metrics", {})
            if self.main:
                ext_csv.log({"split": split, **m, **ext})
            self.logger.info(f"final {split}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in m.items() if isinstance(v, (int, float))))
        self.wandb.finish()
        return final

    # -------------------------------------------------------- checkpoints --

    def save_checkpoint(self, tag: str) -> None:
        """The full train state as ``<tag>.ckpt`` and ``best_metric`` in
        ``<tag>.meta.json``, so that a resume cannot regress ``best``."""
        t0 = time.perf_counter()
        meta = {"model_name": self.cfg.model_name, "num_classes": self.num_classes,
                "task": self.task, "use_ema": bool(self.use_ema)}
        nbytes = save_state(self.path_to_save / f"{tag}.ckpt", self.state, self.generator, meta)
        self._checkpoint_written(tag, nbytes, t0)

    def _checkpoint_written(self, tag: str, nbytes: int, t0: float) -> None:
        if self.main:
            (self.path_to_save / f"{tag}.meta.json").write_text(
                json.dumps({"best_metric": self.best_metric}))
        par.barrier(f"{tag}.meta.json")  # the other ranks read it after rank 0 wrote it
        self.timing["checkpoint"].append({"tag": tag, "step": self.state.step, "bytes": nbytes,
                                          "seconds": time.perf_counter() - t0})

    def _to_device(self, batch: Dict) -> Dict:
        """A loader batch on the device: under DP, this rank's rows of it."""
        if self.dp_enabled:
            batch = par.shard_batch(batch)
        return to_device(batch, self.device)

    def load_checkpoint(self, tag: str) -> None:
        path = self.path_to_save / f"{tag}.ckpt"
        if path.exists():
            restore_state(path, self.state, self.generator)
        meta = self.path_to_save / f"{tag}.meta.json"
        if meta.exists():
            self.best_metric = float(json.loads(meta.read_text()).get("best_metric", -1.0))


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m dfine_tpu_torch.apps.train``, whose ``main`` this is."""
    from ..apps.train import main as app_main

    app_main(argv)


if __name__ == "__main__":
    main()
