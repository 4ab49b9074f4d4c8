"""Extra pyramid levels (``decoder.num_levels`` above the encoder's maps)
of the port against the JAX package on the CPU, fp32, at size n, 320 px,
with every JAX leaf re-drawn from a numpy seed and bridged
(``test_torch_port_helpers``' model variants): ``num_levels`` 3 over n's
two feature maps, with points (6, 6, 4). The third level is a 3x3 stride-2
conv and BatchNorm over the unprojected last map, 5 x 5 at 320 px
(decoder.py:374-385).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from test_torch_port_helpers import (NO_LAB, VARIANT_B, VARIANT_CLASSES, VARIANT_G,
                                     VARIANT_IMG, VARIANT_SIZE, compare_sets,
                                     jax_template_shapes, patch_jax_dn_key, port_model_from,
                                     port_view, random_variables, variant_batch,
                                     variant_step_against_jax)

EXTRA = (("decoder.num_levels", 3), ("decoder.num_points", (6, 6, 4)))
DN_KEY_SEED = 5


def _variant(overrides):
    jmodel, shapes = jax_template_shapes(VARIANT_SIZE, VARIANT_CLASSES, False, VARIANT_IMG,
                                         overrides)
    return jmodel, random_variables(shapes, seed=31)


def test_extra_level_eval_outputs_match_jax():
    """The extra level's conv is 3x3, stride 2, padding 1 and reads 128
    channels; eval outputs within SET_TOL of JAX's, aligned by box."""
    jmodel, variables = _variant(EXTRA)
    port = port_model_from(variables, VARIANT_SIZE, VARIANT_CLASSES, False, EXTRA)
    conv = port.decoder.input_proj[2].conv
    assert (conv.kernel_size, conv.stride, conv.padding) == ((3, 3), (2, 2), (1, 1))
    assert conv.in_channels == 128 and port.decoder.extra_levels == 1
    images, _ = variant_batch(6)
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(images))
    with torch.no_grad():
        ours = port(torch.from_numpy(images.transpose(0, 3, 1, 2).copy()))
    compare_sets(ref, ours)


def test_extra_level_train_step_matches_jax(monkeypatch):
    """One step with the CDN queries (no LAB: ``NO_LAB``) against the JAX
    step by ``check_step``'s rules, then the eval outputs; the extra
    level's conv moved and its BatchNorm statistics are JAX's (inside
    ``check_step``)."""
    overrides = EXTRA + NO_LAB
    jmodel, variables = _variant(overrides)
    noise = patch_jax_dn_key(monkeypatch, DN_KEY_SEED, VARIANT_B, VARIANT_G, VARIANT_CLASSES)
    port = variant_step_against_jax(jmodel, variables, overrides, noise)
    before = port_view(port, variables)
    key = "decoder.input_proj.2.conv.weight"
    assert not np.array_equal(port.state_dict()[key].numpy(), before[key])


def _nchw(images):
    return torch.from_numpy(images.transpose(0, 3, 1, 2).copy())


def test_extra_level_deploy_fusion_and_served_weights(tmp_path):
    """The serving fold (``fold_for_serving``, fp32) folds the extra level's
    BatchNorm into its conv: the folded model against the unfused one and
    against JAX's ``convert_to_deploy`` on the same weights, aligned by box,
    within SET_TOL (the fold reorders f32 sums, and top-k may then order
    near-tied queries otherwise). ``TorchModel``
    with ``cfg_overrides`` takes the port's weights written as ``.npz`` and
    holds the same tensors (bit-equal)."""
    from dfine_tpu.infer.fuse import convert_to_deploy as jax_deploy

    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.infer.fuse import FoldedBatchNorm2d, FoldedConv2d, fold_for_serving
    from dfine_tpu_torch.utils.checkpoint import port_variables

    jmodel, variables = _variant(EXTRA)
    port = port_model_from(variables, VARIANT_SIZE, VARIANT_CLASSES, False, EXTRA)
    npz = tmp_path / "extra.npz"
    np.savez(npz, **port_variables(port))
    images, _ = variant_batch(8)
    with torch.no_grad():
        before = port(_nchw(images))
        fused = fold_for_serving(port, torch.float32)
        after = fused(_nchw(images))
    assert type(fused.decoder.input_proj[2].norm) is FoldedBatchNorm2d
    assert type(fused.decoder.input_proj[2].conv) is FoldedConv2d
    compare_sets({k: v.numpy() for k, v in before.items()}, after)
    jfused = jax.tree.map(jnp.asarray, jax_deploy(jax.tree.map(np.asarray, variables)))
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(jfused, jnp.asarray(images))
    compare_sets(ref, after)

    served = TorchModel(VARIANT_SIZE, str(npz), VARIANT_CLASSES, VARIANT_IMG, VARIANT_IMG,
                        half=False, device="cpu", cfg_overrides=EXTRA)
    ours = port_model_from(variables, VARIANT_SIZE, VARIANT_CLASSES, False, EXTRA)
    for (k, a), b in zip(ours.state_dict().items(), served.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_extra_level_pt2_answers_as_the_fused_model(tmp_path):
    """``export_model(..., cfg_overrides=...)`` writes the 3-level model's
    ``.pt2`` (fp32, on the CPU): the loaded program answers as
    ``TorchModel``'s model (the serving fold) through the same serving
    program, bit for bit, and calls the sampling op."""
    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.export import ServingProgram, export_model
    from dfine_tpu_torch.utils.checkpoint import port_variables

    _, variables = _variant(EXTRA)
    npz = tmp_path / "extra.npz"
    np.savez(npz, **port_variables(port_model_from(variables, VARIANT_SIZE, VARIANT_CLASSES,
                                                   False, EXTRA)))
    arts = export_model(VARIANT_SIZE, str(npz), VARIANT_CLASSES, tmp_path / "out",
                        input_size=(VARIANT_IMG, VARIANT_IMG), half=False,
                        formats=("exported",), device="cpu", cfg_overrides=EXTRA)
    program = torch.export.load(arts["exported"])
    assert any("dfine_tpu_torch.ms_deform_attn_fwd" in str(n.target)
               for n in program.graph.nodes if n.op == "call_function")
    fused = TorchModel(VARIANT_SIZE, str(npz), VARIANT_CLASSES, VARIANT_IMG, VARIANT_IMG,
                       half=False, device="cpu", cfg_overrides=EXTRA)
    x = _nchw(variant_batch(10)[0][:1])
    with torch.no_grad():
        ref, ours = ServingProgram(fused.model)(x), program.module()(x)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
