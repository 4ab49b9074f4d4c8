"""``Trainer.evaluate`` against the JAX package's eval composition on the
CPU, n at 320 px, detect and det+seg, on the same re-drawn weights."""

from pathlib import Path

import numpy as np
import pytest

from test_torch_port_helpers import (jax_template_shapes, port_model_from, random_variables,
                                     write_dataset)
from test_torch_port_trainer import IMG, NUM_CLASSES, _config

# Counts equal, the other metrics within METRIC_ATOL (a float32 IoU's
# rounding), the mask-matched ones within MASK_METRIC_ATOL (both sides resize
# bf16 mask probabilities, and a pixel at 0.5 may fall either way). The GT
# boxes are the JAX model's own detections as they are: a jittered box may
# straddle one of COCO's IoU thresholds, where the two sides' ~1e-5 box gap
# flips a match.
METRIC_ATOL, MASK_METRIC_ATOL = 1e-6, 2e-3


def _jax_eval(jmodel, variables, names, data, task, conf):
    """The JAX package's eval composition: its dataset's eval samples ->
    apply -> topk_decode (masks of the top 100 in bf16) ->
    postprocess_predictions -> masks_to_rle -> Validator(extended=True)."""
    import jax
    import jax.numpy as jnp

    from dfine_tpu.data.dataset import DatasetConfig, DetectionDataset
    from dfine_tpu.data.labels import polygons_to_masks
    from dfine_tpu.eval.rle import masks_to_rle
    from dfine_tpu.eval.validator import Validator
    from dfine_tpu.postprocess import postprocess_predictions, topk_decode

    ds = DetectionDataset(data, names, DatasetConfig(img_size=(IMG, IMG), task=task, max_gt=8),
                          mode="val")
    samples, gts = zip(*[ds.load_for_eval(i) for i in range(len(ds))])

    @jax.jit
    def infer(v, x):
        out = jmodel.apply(v, x, train=False)
        dec = topk_decode(out["pred_logits"], out["pred_boxes"], 300, masks=out.get("pred_masks"))
        if "masks" in dec:
            dec["masks"] = dec["masks"][:, :100].astype(jnp.bfloat16)
        return dec

    images = jnp.asarray(np.stack([s["image"] for s in samples]))
    dec = jax.tree.map(np.asarray, infer(variables, images))
    if conf is None:
        return dec
    preds, gt_list = [], []
    for i, g in enumerate(gts):
        p = postprocess_predictions({k: v[i:i + 1] for k, v in dec.items()}, (IMG, IMG),
                                    [g["orig_size"]], conf, False)[0]
        entry = {"labels": g["labels"], "boxes": g["boxes_abs"]}
        if task == "segment":
            entry["masks_rle"] = masks_to_rle(polygons_to_masks(g["polygons"], *g["orig_size"]))
            p["masks_rle"] = masks_to_rle(p.pop("masks"))
        preds.append(p)
        gt_list.append(entry)
    names_map = {0: "a", 1: "b", 2: "c"}
    return Validator(gt_list, preds, names_map, conf_thresh=conf, iou_thresh=0.5,
                     mask_batch_size=1000).compute_metrics(extended=True)


@pytest.mark.parametrize("task", ["detect", "segment"])
def test_evaluate_matches_jax_composition(tmp_path, task):
    """Both sides on the same re-drawn weights (carried by
    ``load_jax_variables``), fp32. The val frames are labelled with the
    JAX model's own top detections, so that matches exist; the
    threshold sits in the widest gap of the scores so that both keep the same
    detections. Counts and box metrics within METRIC_ATOL, mask metrics
    within MASK_METRIC_ATOL."""
    from dfine_tpu_torch.train.trainer import Trainer

    seg = task == "segment"
    data = tmp_path / "data" / "dataset"
    names = write_dataset(data, 4, (90, 120), seed=4, n_val=2)[2:]
    jmodel, shapes = jax_template_shapes("n", NUM_CLASSES, seg, IMG)
    variables = random_variables(shapes, seed=6)
    if seg:  # wider mask logits: masks that are not empty
        variables["params"]["decoder"]["mask_head"]["layers_2"]["kernel"] *= 30
    dec = _jax_eval(jmodel, variables, names, data, task, None)
    for i, name in enumerate(names):
        lines = []
        for q in np.argsort(-dec["scores"][i])[:6]:  # the top detections, cxcywh normalized
            cx, cy, bw, bh = np.clip(dec["boxes"][i, q], 0.02, 0.98)
            lines.append(f"{int(dec['labels'][i, q])} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
        (data / "labels" / f"{Path(name).stem}.txt").write_text("\n".join(lines) + "\n")
    s = np.sort(dec["scores"].reshape(-1))[::-1]
    k = 8 + int(np.argmax(s[7:30] - s[8:31]))
    conf = float((s[k - 1] + s[k]) / 2)
    ref = _jax_eval(jmodel, variables, names, data, task, conf)

    trainer = Trainer(_config(tmp_path, "eval", task=task, **{"train.conf_thresh": conf}),
                      device="cpu")
    port = port_model_from(variables, "n", NUM_CLASSES, seg)
    trainer.state.ema.load_state_dict(port.state_dict())
    ours = trainer.evaluate("val", extended=True)
    assert ref["TPs"] > 0 and ref["FPs"] > 0 and ref["mAP_50"] > 0
    assert set(ours) == set(ref)
    for key, v in ref.items():
        if isinstance(v, dict):
            assert set(ours[key]) == set(v)
            for k2, v2 in v.items():
                atol = MASK_METRIC_ATOL if seg and k2.startswith(("iou", "f1", "prec", "rec")) \
                    else METRIC_ATOL
                assert abs(ours[key][k2] - v2) <= atol, (key, k2, ours[key][k2], v2)
        else:
            atol = MASK_METRIC_ATOL if seg and (key == "iou" or "mask" in key) else METRIC_ATOL
            assert abs(ours[key] - v) <= atol, (key, ours[key], v)
