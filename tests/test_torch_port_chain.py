"""The train chain's step body (`train/engine.py::build_train_chain`, a CUDA
graph on the card) run eagerly on the CPU, at the reduced size of
`test_torch_port_train.py`.

A graph replays what it captured, so the chain's step reads nothing from the
host: its AdamW is `optim.capturable_adamw` (step counts and lrs on the
device), its schedule `optim.DeviceStepLR`, its masks one generator's. The
body itself is `build_train_step`'s. Here, on the CPU:

* the step on the capturable state against `build_train_step` on the usual
  AdamW and LambdaLR, 3 steps at zero rates: the first step's loss and
  grad_norm bit-equal (one forward and backward), the parameters after it
  within ROUNDING_RTOL of each tensor's largest element, the later losses and
  norms within 1e-6 relative;
* the two optimizers on the same gradients over 3 steps across an lr drop:
  parameters and moments within ROUNDING_RTOL of each tensor's largest element;
* `DeviceStepLR`'s lrs equal to LambdaLR's in float32 at every step, across
  drops and far past them;
* the masks drawn from one generator: the same for the chain's body and for
  `build_train_step` given the same generator, new at each step;
* 3 steps against the JAX `build_train_step` applied 3 times (the body of
  the JAX `bench_train.py --chain` scan), zero rates: each step's loss
  components within 1e-4 and grad_norm within 1e-3 relative
  (`test_torch_port_train.py`'s loss and gradient bounds), and the relative L2
  error of all parameter updates within 1e-3. Not element by element: Adam
  divides each gradient element by its own scale, so an element whose
  gradient is small against its tensor's largest (held to 1e-3 of that)
  moves by another fraction of its lr;
* the refusals: a CPU model, more than one process, `--host_dtype bf16`
  with `--dtype float32`.

`torch.optim.AdamW(capturable=True)` takes CUDA tensors only; the CPU runs
its arithmetic with that check lifted (`_capturable_on_cpu`).
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwdetr_tpu.config import ModelConfig as JaxModelConfig
from lwdetr_tpu.config import TrainConfig as JaxTrainConfig
from lwdetr_tpu.models.criterion import SetCriterion as JaxSetCriterion
from lwdetr_tpu.models.lwdetr import build_model as jax_build_model
from lwdetr_tpu.train import engine as jengine
from lwdetr_tpu.train import optim as joptim
from lwdetr_tpu_torch import bench_train
from lwdetr_tpu_torch.config import ModelConfig, TrainConfig
from lwdetr_tpu_torch.models import drop
from lwdetr_tpu_torch.models.criterion import SetCriterion
from lwdetr_tpu_torch.train import engine, optim
from lwdetr_tpu_torch.weights import state_dict_from_jax

NANO = ModelConfig(
    encoder="vit_tiny", vit_encoder_num_layers=2, window_block_indexes=(0,),
    out_feature_indexes=(0, 1), projector_scale=("P4",), hidden_dim=64, dim_feedforward=128,
    sa_nheads=4, ca_nheads=8, dec_n_points=2, dec_layers=2, group_detr=3, num_queries=16,
    num_classes=7, two_stage=True, bbox_reparam=True, lite_refpoint_refine=True)
TCFG = TrainConfig(ia_bce_loss=True, cls_loss_coef=1.0, use_ema=True, lr=2e-4, lr_encoder=3e-4,
                   lr_component_decay=0.7, max_gt=8, lr_drop=1)
IMG, BATCH, STEPS = 128, 2, 3
NITER = 2  # steps an epoch: with lr_drop 1 the lr drops before the third step
# capturable AdamW forms Adam's bias corrections on the device in float32, the
# usual one on the host in float64: beta2 = 0.999 is 0.99900001 in float32, so
# 1 - beta2 is 1.3e-5 off and the update's sqrt(1 - beta2^t) 6.4e-6 at the first
# step; a tensor that was zero before it (a bias) is the update alone
ROUNDING_RTOL = 1e-5
LOSS_RTOL = 1e-6  # the later steps' losses and norms: a forward on those parameters
JAX_LOSS_ATOL, JAX_RTOL = 1e-4, 1e-3


def _capturable_on_cpu():
    return mock.patch("torch.optim.adam._get_capturable_supported_devices",
                      lambda supports_xla=True: ["cpu"])


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model initialised in train mode, its state and 3 steps of its
    `build_train_step` on one batch (zero rates); the batch."""
    jm = JaxModelConfig(**dataclasses.asdict(NANO))
    jt = JaxTrainConfig(**dataclasses.asdict(TCFG))
    jmodel = jax_build_model(jm)
    tx = joptim.build_optimizer(
        jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                                            "dropout": jax.random.PRNGKey(0)},
                                           jnp.zeros((1, IMG, IMG, 3)), train=True))["params"],
        jm, jt, NITER)
    # `jengine.create_train_state` with its init jitted (eager flax compiles each primitive)
    variables = jax.jit(lambda x: jmodel.init({"params": jax.random.PRNGKey(0),
                                                "dropout": jax.random.PRNGKey(1)}, x, train=True))(
        jnp.zeros((1, IMG, IMG, 3), jnp.float32))
    params, stats = variables["params"], variables["batch_stats"]
    state = jengine.TrainState(params, stats, tx.init(params),
                               jax.tree.map(jnp.copy, {"params": params, "batch_stats": stats}),
                               jnp.zeros((), jnp.int32))
    rng = np.random.default_rng(3)
    batch = {
        "images": rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32),
        "labels": rng.integers(0, NANO.num_classes, (BATCH, TCFG.max_gt)).astype(np.int32),
        "boxes": np.concatenate([rng.uniform(0.3, 0.7, (BATCH, TCFG.max_gt, 2)),
                                 rng.uniform(0.1, 0.4, (BATCH, TCFG.max_gt, 2))],
                                -1).astype(np.float32),
        "valid": np.arange(TCFG.max_gt)[None] < np.array([[3], [5]]),
    }
    start = (jax.tree.map(np.asarray, state.params), jax.tree.map(np.asarray, state.batch_stats))
    step = jengine.build_train_step(jmodel, JaxSetCriterion(jm, jt), tx, TCFG.ema_decay, True,
                                    NANO.vit_encoder_num_layers, donate=False,
                                    static_zero_drop_path=True, static_zero_dropout=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for i in range(STEPS):
        state, m = step(state, jbatch, jax.random.PRNGKey(i), jnp.float32(0), jnp.float32(0))
        metrics.append({k: float(v) for k, v in m.items()})
    end = state_dict_from_jax(jax.tree.map(np.asarray, state.params),
                              jax.tree.map(np.asarray, state.batch_stats), NANO)
    return dict(start=start, batch=batch, metrics=metrics, end=end)


def _state(start, tcfg=TCFG):
    return engine.create_train_state(NANO, tcfg, niter_per_ep=NITER, device="cpu",
                                     state_dict=state_dict_from_jax(*start, NANO))


def _batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _rel(a, b, floor=0.0):
    """max |a - b| over max |b| (floored)."""
    return ((a - b).abs().max() / b.abs().max().clamp(min=max(floor, 1e-30))).item()


def _chain_body_step(state, tcfg=TCFG):
    """The chain's body on a capturable state, run eagerly: `build_train_step`
    after `make_capturable` (the same `_step_body` the graph captures)."""
    engine.make_capturable(state, tcfg, NITER)
    return engine.build_train_step(state, SetCriterion(NANO, tcfg), tcfg)


@pytest.fixture(scope="module")
def two_runs(jax_run):
    """3 steps of `build_train_step` and of the chain's body, zero rates."""
    batch = _batch(jax_run["batch"])
    plain, chain = _state(jax_run["start"]), _state(jax_run["start"])
    plain_step = engine.build_train_step(plain, SetCriterion(NANO, TCFG), TCFG)
    out = {"plain": [], "chain": [], "after_one": {}}
    with _capturable_on_cpu():
        chain_step = _chain_body_step(chain)
        for i in range(STEPS):
            for name, step, st in (("plain", plain_step, plain), ("chain", chain_step, chain)):
                m = step(batch)
                out[name].append({k: v.item() for k, v in m.items()})
                if i == 0:
                    out["after_one"][name] = {n: p.detach().clone()
                                              for n, p in st.model.named_parameters()}
    out.update(plain_state=plain, chain_state=chain)
    return out


def test_the_first_step_is_bit_equal_and_the_optimizer_rounds_within_bounds(two_runs):
    first_plain, first_chain = two_runs["plain"][0], two_runs["chain"][0]
    # every loss component and grad_norm: one forward and backward
    assert first_chain == first_plain
    a, b = two_runs["after_one"]["chain"], two_runs["after_one"]["plain"]
    worst = max(_rel(a[n], b[n]) for n in b)
    assert 0 < worst <= ROUNDING_RTOL, worst  # capturable AdamW rounds apart, within 1e-6
    for p, c in zip(two_runs["plain"][1:], two_runs["chain"][1:]):
        for k in ("loss", "grad_norm"):
            assert c[k] == pytest.approx(p[k], rel=LOSS_RTOL), k


def test_capturable_adamw_and_device_step_lr_on_given_gradients(jax_run):
    """3 steps on the same gradients, the lr dropping before the third: each
    parameter and moment within 1e-6 of its tensor's largest element."""
    plain, chain = _state(jax_run["start"]), _state(jax_run["start"])
    rng = np.random.default_rng(11)
    with _capturable_on_cpu():
        engine.make_capturable(chain, TCFG, NITER)
        for _ in range(STEPS):
            for (n, p), q in zip(plain.model.named_parameters(), chain.model.parameters()):
                g = torch.from_numpy((rng.standard_normal(p.shape)
                                      * 10.0 ** rng.integers(-4, 1)).astype(np.float32))
                p.grad, q.grad = g.clone(), g.clone()
            for st in (plain, chain):
                st.optimizer.step()
                st.scheduler.step()
    for (n, p), q in zip(plain.model.named_parameters(), chain.model.parameters()):
        assert _rel(q.detach(), p.detach()) <= ROUNDING_RTOL, n
        for k in ("exp_avg", "exp_avg_sq"):
            assert _rel(chain.optimizer.state[q][k], plain.optimizer.state[p][k]) <= ROUNDING_RTOL
        assert chain.optimizer.state[q]["step"].item() == STEPS
    assert chain.optimizer.param_groups[0]["capturable"]


def test_device_step_lr_equals_lambda_lr_in_float32_across_drops(jax_run):
    state = _state(jax_run["start"], dataclasses.replace(TCFG, lr_drop=2))
    lam = state.scheduler
    with _capturable_on_cpu():
        opt = optim.capturable_adamw(state.optimizer)
    dev = optim.DeviceStepLR.of(lam, opt, 2, NITER)
    seen = set()
    for step in range(13):  # drops at 4, 8 and 12
        expect = torch.tensor([float(g["lr"]) for g in state.optimizer.param_groups],
                              dtype=torch.float32)
        assert torch.equal(dev.lrs, expect), step
        assert all(g["lr"].data_ptr() == dev.lrs[i].data_ptr()
                   for i, g in enumerate(opt.param_groups))
        seen.add(expect[0].item())
        lam.step()
        dev.step()
    assert len(seen) == 4
    far = 10 ** 6
    dev.step_count.fill_(far)
    dev.rewrite()
    lam.last_epoch = far
    lam.step(), dev.step()
    assert torch.equal(dev.lrs, torch.tensor([float(g["lr"]) for g in state.optimizer.param_groups],
                                             dtype=torch.float32))


def test_masks_from_one_generator_equal_build_train_steps_and_change_each_step(jax_run):
    batch = _batch(jax_run["batch"])
    tcfg = TCFG
    plain, chain = _state(jax_run["start"]), _state(jax_run["start"])
    drawn = {"plain": [], "chain": []}

    def recorder(name, gen):
        source = drop.Bernoulli(gen)

        def draw(keep, shape, like):
            drawn[name][-1].append(source(keep, shape, like))
            return drawn[name][-1][-1]
        return draw

    plain_step = engine.build_train_step(plain, SetCriterion(NANO, tcfg), tcfg)
    src = {name: recorder(name, torch.Generator().manual_seed(5)) for name in drawn}
    with _capturable_on_cpu():
        chain_step = _chain_body_step(chain)
        for _ in range(2):
            for name, step in (("plain", plain_step), ("chain", chain_step)):
                drawn[name].append([])
                step(batch, 0.2, 0.1, mask_source=src[name])
    # block 1's attention and MLP (block 0's rate is 0), and the decoder's sites
    assert [len(m) for m in drawn["chain"]] == [len(m) for m in drawn["plain"]]
    assert len(drawn["chain"][0]) > 2
    for a, b in zip(drawn["plain"], drawn["chain"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert any(not torch.equal(x, y) for x, y in zip(*drawn["chain"]))
    assert all(set(torch.unique(m).tolist()) <= {0.0, 1.0} for m in drawn["chain"][0])


def test_three_chain_steps_match_the_jax_train_step_applied_three_times(two_runs, jax_run):
    for i, (got, ref) in enumerate(zip(two_runs["chain"], jax_run["metrics"])):
        assert set(got) == set(ref)
        for k in ref:
            if k == "grad_norm":
                assert got[k] == pytest.approx(ref[k], rel=JAX_RTOL), i
            else:
                assert got[k] == pytest.approx(ref[k], abs=JAX_LOSS_ATOL), (i, k)
    named = dict(two_runs["chain_state"].model.named_parameters())
    start, end = state_dict_from_jax(*jax_run["start"], NANO), jax_run["end"]
    moved = [(p.detach() - start[n], end[n] - start[n]) for n, p in named.items()]
    err = sum((a - b).double().square().sum() for a, b in moved)
    assert (err / sum(b.double().square().sum() for _, b in moved)).sqrt().item() <= JAX_RTOL


def test_the_chain_refuses_the_cpu_and_more_than_one_process(jax_run):
    state = _state(jax_run["start"])
    crit = SetCriterion(NANO, TCFG)
    with pytest.raises(ValueError, match="needs the card"):
        engine.build_train_chain(state, crit, TCFG, _batch(jax_run["batch"]), NITER)
    with mock.patch.object(engine, "world_size", return_value=2), \
            pytest.raises(ValueError, match="one process"):
        engine.build_train_chain(state, crit, TCFG, _batch(jax_run["batch"]), NITER)


def test_host_dtype_bf16_needs_a_bf16_model():
    with pytest.raises(ValueError, match="--dtype bfloat16"):
        bench_train.check_host_dtype(torch.float32, torch.bfloat16)
    bench_train.check_host_dtype(torch.bfloat16, torch.bfloat16)
    bench_train.check_host_dtype(torch.float32, torch.float32)
    args = bench_train.parser().parse_args(["--chain", "10", "--host_dtype", "bf16",
                                            "--dtype", "bfloat16"])
    assert (args.chain, args.host_dtype, args.dtype) == (10, "bf16", "bfloat16")
    assert bench_train.parser().parse_args([]).chain == 0
    with pytest.raises(SystemExit):
        bench_train.parser().parse_args(["--host_dtype", "f16"])
    with mock.patch("sys.argv", ["bench_train", "--host_dtype", "bf16"]), \
            pytest.raises(ValueError, match="--dtype bfloat16"):
        bench_train.main()
