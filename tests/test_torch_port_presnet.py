"""The port's PResNet encoder (`lwdetr_tpu_torch/models/presnet.py`) against
the JAX package's (`lwdetr_tpu/models/presnet.py`), on the CPU.

The JAX module's variables are drawn with numpy at the shapes of its init
(BatchNorm statistics that make no norm an identity) and carried into the
port by the port's own PResNet rows of the checkpoint mapping
(`weights.presnet_mapping`). Depths 18 (basic blocks) and 50 (bottlenecks),
at 64 and 128 px and at 113 px, an odd size whose stage maps of 29 and 15
take the edge-padded average pool of the stride-2 shortcuts. In f32 within
1e-4 of the map's largest magnitude; in bf16 against the JAX module's bf16 within a bound measured here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwdetr_tpu.models.presnet import PResNet as JaxPResNet
from lwdetr_tpu.models.presnet import RESNET_CFG as JAX_RESNET_CFG
from lwdetr_tpu.models.presnet import _avg_pool_2x_ceil as jax_avg_pool_2x_ceil
from lwdetr_tpu_torch.models import presnet
from lwdetr_tpu_torch.weights import presnet_mapping, tensors_from_jax

ATOL = 1e-4  # of the largest magnitude: f32 sums in another order through 50 layers
# measured here: port bf16 vs JAX bf16, max |difference| over the
# concatenated map relative to its largest magnitude, 1.26e-2 (res18 at 113 px)
# / 1.02e-2 (res50 at 64 px), against JAX's own bf16 vs its f32 9.7e-3 /
# 1.11e-2: bf16 rounds the convolutions' inputs and results, whose sums run
# in another order on each side. The bound leaves about 3x.
BF16_REL = 0.04


def _variables(depth: int, img: int, seed: int = 0):
    """The JAX module and random variables of its shapes (`jax.eval_shape`
    of its init: no initializer runs): kernels scaled by their fan-in,
    scales near 1, small biases, statistics that make no norm an identity."""
    model = JaxPResNet(depth=depth)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed), jnp.zeros((1, img, img, 3)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            x = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            x = 0.1 * rng.standard_normal(shape)
        return x.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    return model, variables["params"], variables["batch_stats"]


def _apply(model, train=False):
    """The jitted forward (one compile, where op-by-op dispatch compiles each
    primitive)."""
    if train:
        return jax.jit(lambda p, s, x: model.apply({"params": p, "batch_stats": s}, x, train=True,
                                                   mutable=["batch_stats"]))
    return jax.jit(lambda p, s, x: model.apply({"params": p, "batch_stats": s}, x, train=False))


def _port(depth: int, params, stats) -> presnet.PResNet:
    sd = tensors_from_jax(presnet_mapping("enc", ("enc",), depth), {"enc": params},
                          {"enc": stats})
    model = presnet.PResNet(depth)
    model.load_state_dict({k[len("enc."):]: v for k, v in sd.items()}, strict=True)
    return model


_BRIDGED = {}


def _bridged(depth: int):
    """(depth, JAX module, params, stats, port module), built once a depth."""
    if depth not in _BRIDGED:
        model, params, stats = _variables(depth, 64)
        _BRIDGED[depth] = depth, model, params, stats, _port(depth, params, stats)
    return _BRIDGED[depth]


def _images(img: int, seed: int = 1, batch: int = 2):
    return np.random.default_rng(seed).standard_normal((batch, img, img, 3)).astype(np.float32)


def test_copies_of_the_jax_tables():
    assert presnet.RESNET_CFG == JAX_RESNET_CFG
    for depth in presnet.RESNET_CFG:
        assert presnet.out_channels(depth) == JaxPResNet(depth=depth).out_channels
    assert presnet.out_channels(18) == [896] and presnet.out_channels(50) == [3584]
    assert presnet.depth_of("res50vd") == 50 and presnet.depth_of("resnet18") == 18


@pytest.mark.parametrize("depth,img", [(18, 64), (18, 113), (18, 128), (50, 64), (50, 113)])
def test_eval_output_matches_jax(depth, img):
    depth, model, params, stats, tmodel = _bridged(depth)
    x = _images(img)
    ref = _apply(model)(params, stats, jnp.asarray(x))
    with torch.no_grad():
        out = tmodel.eval()(torch.from_numpy(x))
    assert len(out) == len(ref) == 1
    side = -(-img // 16)
    assert out[0].shape == (2, side, side, presnet.out_channels(depth)[0]) == ref[0].shape
    ref = np.asarray(ref[0])
    np.testing.assert_allclose(out[0].numpy(), ref, atol=ATOL * np.abs(ref).max())


@pytest.mark.parametrize("depth", [18, 50])
def test_norms_stay_frozen_in_train_mode(depth):
    """`freeze_norm=True`: in train mode each BatchNorm still normalizes with
    its running statistics and never updates them (JAX: the same output, the
    same batch_stats), while its weight and bias take gradients."""
    depth, model, params, stats, tmodel = _bridged(depth)
    x = _images(64, seed=2)
    ref, new = _apply(model, train=True)(params, stats, jnp.asarray(x))
    for a, b in zip(jax.tree.leaves(new["batch_stats"]), jax.tree.leaves(stats)):
        np.testing.assert_array_equal(np.asarray(a), b)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    tmodel.train()
    try:
        out = tmodel(torch.from_numpy(x))
        out[0].square().sum().backward()
    finally:
        tmodel.eval()
    ref = np.asarray(ref[0])
    np.testing.assert_allclose(out[0].detach().numpy(), ref, atol=ATOL * np.abs(ref).max())
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, before[k]), k
    norm = tmodel.res0_0.branch2a.norm
    assert norm.weight.grad is not None and norm.weight.grad.abs().max() > 0
    assert norm.bias.grad is not None and norm.running_mean.grad is None
    tmodel.zero_grad(set_to_none=True)


@pytest.mark.parametrize("depth,img", [(18, 113), (50, 64)])
def test_gradients_match_jax_grad(depth, img):
    """d(sum of squares of the map) / d(parameters) and d(images) against
    `jax.grad` in train mode, each tensor within 1e-4 of its largest gradient
    (res18 at the odd size 113, through the edge-padded pools). Trap (b): a
    pre-activation within an ulp of 0 takes the other side of a ReLU under
    another f32 summation order and moves a bias gradient by 0.5% (res50 at
    113 with these inputs: one unit of res2_0 at 5.6e-7, where JAX's f32 and
    the port's f64 agree to 4e-7); at 64 px no unit lies that close."""
    depth, model, params, stats, tmodel = _bridged(depth)
    x = _images(img, seed=3, batch=1)

    def loss(p, xi):
        out = model.apply({"params": p, "batch_stats": stats}, xi, train=True,
                          mutable=["batch_stats"])[0]
        return jnp.sum(out[0] ** 2)

    jgp, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tmodel.train()
    try:
        tmodel(xt)[0].square().sum().backward()
    finally:
        tmodel.eval()
    ref = tensors_from_jax([e for e in presnet_mapping("enc", ("enc",), depth)
                            if e[1] == "params"], {"enc": jax.tree.map(np.asarray, jgp)}, {})
    named = dict(tmodel.named_parameters())
    assert {k[len("enc."):] for k in ref} == set(named)
    worst = 0.0
    for k, g in ref.items():
        got = named[k[len("enc."):]].grad
        worst = max(worst, ((got - g).abs().max() / g.abs().max().clamp(min=1e-12)).item())
    tmodel.zero_grad(set_to_none=True)
    assert worst <= 1e-4, worst
    gx = np.asarray(jgx)
    np.testing.assert_allclose(xt.grad.numpy(), gx, atol=1e-4 * np.abs(gx).max())


@pytest.mark.parametrize("depth,img", [(18, 113), (50, 64)])
def test_bf16_output_matches_jax_bf16(depth, img):
    """bf16 compute with float32 parameters and statistics (the JAX module at
    dtype=bfloat16): the frozen norms compute in f32 and round once, as
    flax's; the whole map within `BF16_REL` of its largest magnitude."""
    depth, _, params, stats, tmodel = _bridged(depth)
    x = _images(img, seed=4)
    jmodel = JaxPResNet(depth=depth, dtype=jnp.bfloat16)
    ref = np.asarray(_apply(jmodel)(params, stats, jnp.asarray(x))[0].astype(jnp.float32))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x).to(torch.bfloat16))[0]
    assert out.dtype == torch.bfloat16
    rel = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
    assert rel <= BF16_REL, rel


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (2, 7, 6, 3), (1, 7, 9, 4), (1, 15, 15, 2)])
def test_avg_pool_edge_pads_odd_sides_as_the_jax_package(shape):
    """`_avg_pool_2x_ceil` repeats the last row / column of an odd side
    before the 2x2 mean (the JAX package's rule, whose comment sets it apart
    from the reference's `AvgPool2d(ceil_mode=True)`): the port pools the
    same. A border cell then holds its valid elements twice each, so its
    mean is the mean of the valid elements, which `ceil_mode` takes: the
    two rules agree up to the order of the sums."""
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax_avg_pool_2x_ceil(jnp.asarray(x)))
    out = presnet.avg_pool_2x_ceil(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape == (shape[0], -(-shape[1] // 2), -(-shape[2] // 2), shape[3])
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    ceil = torch.nn.functional.avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 2, 2,
                                          ceil_mode=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ceil.numpy(), ref, atol=1e-6)


# ---- a reduced LW-DETR on PResNet-18 ----------------------------------------


def _res18(lite: bool):
    from test_torch_port_variants import NANO
    return dataclasses.replace(NANO, encoder="res18vd", lite_refpoint_refine=lite)


def test_res18_lwdetr_eval_outputs_match_jax():
    """LW-DETR on PResNet-18 (its one stride-16 map of 896 channels into the
    P4 projector), the release decoder, 96 x 96: every output set within
    1e-4 of the JAX model's."""
    from test_torch_port_variants import eval_outputs
    cfg = _res18(lite=True)
    jout, tout = eval_outputs(cfg, img=96)
    pairs = [(tout, jout), (tout["enc_outputs"], jout["enc_outputs"])]
    pairs += list(zip(tout["aux_outputs"], jout["aux_outputs"]))
    for t, j in pairs:
        for key in ("pred_logits", "pred_boxes"):
            np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]), atol=1e-4)


def test_res18_lwdetr_train_gradients_match_jax_grad():
    """The same model with the iterative refinement (two-stage, reparameterized
    boxes), in train mode: the losses on the port's matching and every
    parameter's gradient against `jax.grad` (1e-3 of each tensor's largest,
    trap (a)'s floor); PResNet's frozen norms take gradients in their weights
    and biases only, and keep their statistics."""
    from test_torch_port_variants import assert_gradients_match, train_gradients
    cfg = _res18(lite=False)
    run = train_gradients(cfg, img=96)
    assert run["total"] == pytest.approx(run["jtotal"], abs=1e-4)
    assert_gradients_match(run, cfg)
    named = dict(run["tmodel"].named_parameters())
    assert named["backbone.0.encoder.res0_0.branch2a.norm.weight"].grad.abs().max() > 0
    sd = run["tmodel"].state_dict()
    assert int(sd["backbone.0.encoder.res0_0.branch2a.norm.num_batches_tracked"]) == 0
