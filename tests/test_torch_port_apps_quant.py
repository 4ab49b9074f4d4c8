"""``apps.quant`` against the JAX ``dfine_tpu/apps/quant.py`` on the CPU,
on bridged n weights: the ranking, the reverts and the ``export_int8.npz``
artifact, served by both packages. (Its own file so that it runs beside
``test_torch_port_apps.py``'s end-to-end runs.)"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_port_deploy import _compare, _nchw
from test_torch_port_helpers import jax_template_shapes, port_model_from, random_variables
from test_torch_port_trainer import IMG


def test_quant_ranking_reverts_and_artifact_match_jax(tmp_path):
    """On bridged n detect weights: ``rank_by_quant_error`` gives JAX's
    order by key with errors within 1e-6; reverting its first 5 kernels
    gives JAX's ``count_int8``; the port's ``export_int8.npz`` loads into
    JAX as JAX's own reverted tree, bit for bit, and serves in both
    packages within the int8 rule of ``test_torch_port_deploy.py``
    (w8a16, fp32); every kernel reverted gives the fp model's output
    exactly, and its weights hold no ``quant`` scale."""
    from flax import traverse_util

    from dfine_tpu.apps import quant as jax_quant
    from dfine_tpu.infer.int8 import apply_int8, convert_params_int8
    from dfine_tpu.infer.int8 import count_int8 as jax_count
    from dfine_tpu.utils.checkpoint import load_params_npz

    from dfine_tpu_torch.apps import quant as quant_app
    from dfine_tpu_torch.infer import Int8Model
    from dfine_tpu_torch.infer.int8 import convert_int8, count_int8, int8_variables

    jmodel, shapes = jax_template_shapes("n", 3, False, IMG)
    variables = random_variables(shapes, seed=21)
    npv = jax.tree.map(np.asarray, variables)
    v8 = convert_params_int8(npv)
    ref_rank = jax_quant.rank_by_quant_error(npv, v8)
    fp = port_model_from(variables, "n", 3, False)
    q = convert_int8(copy.deepcopy(fp))
    rank = quant_app.rank_by_quant_error(fp, q)
    assert [k for k, _ in rank] == [k for k, _ in ref_rank]
    np.testing.assert_allclose([e for _, e in rank], [e for _, e in ref_rank], atol=1e-6, rtol=0)

    take = [k for k, _ in rank[:5]]
    v8r = jax_quant.revert_kernels(v8, npv, take)
    quant_app.revert_kernels(q, fp, take)
    assert count_int8(q) == jax_count(v8r) and jax_count(v8r)[0] == jax_count(v8)[0] - 5

    path = tmp_path / "export_int8.npz"
    np.savez(path, **int8_variables(q))
    loaded = load_params_npz(path)
    flat_ref = traverse_util.flatten_dict(v8r, sep="/")
    flat = traverse_util.flatten_dict(loaded, sep="/")
    assert set(flat) == set(flat_ref)
    for k, v in flat_ref.items():
        assert flat[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(flat[k], np.asarray(v), err_msg=k)

    x = np.random.default_rng(6).uniform(size=(1, IMG, IMG, 3)).astype(np.float32)
    ref = jax.jit(lambda v, x: apply_int8(jmodel, v, x, train=False))(
        jax.tree.map(jnp.asarray, loaded), jnp.asarray(x))
    served = Int8Model("n", str(path), 3, IMG, IMG, half=False, device="cpu")
    assert count_int8(served.model) == count_int8(q)
    with torch.no_grad():
        ours = served.model(_nchw(x))
    _compare(ref, ours)

    quant_app.revert_kernels(q, fp, [k for k, _ in rank[5:]])
    assert count_int8(q) == (0, count_int8(fp)[1])
    with torch.no_grad():
        a, b = q.eval()(_nchw(x)), fp.eval()(_nchw(x))
    for k in ("pred_logits", "pred_boxes"):
        assert torch.equal(a[k], b[k]), k
    # every kernel reverted leaves no quant scale: the file reads as fp
    # weights, which Int8Model quantizes whole, as JAX's does
    flat_fp = int8_variables(q)
    assert not any(k.startswith("quant/") for k in flat_fp)
    np.savez(path, **flat_fp)
    served = Int8Model("n", str(path), 3, IMG, IMG, half=False, device="cpu")
    assert count_int8(served.model) == count_int8(convert_int8(copy.deepcopy(fp)))
