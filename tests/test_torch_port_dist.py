"""Multi-process training and eval of the port (`lwdetr_tpu_torch/parallel/`)
against the JAX package, on the CPU over `gloo`.

Two launches of two processes each, started with `subprocess` and a
torchrun-style environment:

(i) the train step (`tests/torch_port_dist_child.py`) of a reduced model with
    stochastic depth and dropout, 2 processes x batch 2, against the JAX
    package's step on the global batch of 4 (`jax.value_and_grad` of its model
    and criterion, as `test_torch_port_train.py` holds the one-process step:
    the drop masks drawn with numpy and fed to both sides, each process taking
    its rows; the port's proposal picks and matching replayed) within that
    file's bounds, and against the port's one-process step on the same 4
    images at tighter ones; ZeRO-1 on and off, bit for bit; the sharded
    checkpoint; the engine's own masks as rows of one global draw.
(ii) the eval CLI, 2 processes on the mAP fixture, against `golden_stats.json`.

In process: the launch resolution against the JAX package's, and the ZeRO-1
plan against `zero1_sharding_tree` on a 2-device CPU mesh.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwdetr_tpu.config import ModelConfig as JaxModelConfig
from lwdetr_tpu.config import TrainConfig as JaxTrainConfig
from lwdetr_tpu.models.criterion import SetCriterion as JaxSetCriterion
from lwdetr_tpu.models.criterion import Targets as JaxTargets
from lwdetr_tpu.models.lwdetr import build_model as jax_build_model
from lwdetr_tpu.parallel import dist as jdist
from lwdetr_tpu.parallel.mesh import make_mesh, zero1_sharding_tree
from lwdetr_tpu_torch.config import ModelConfig, TrainConfig, get_config
from lwdetr_tpu_torch.models import criterion as cm
from lwdetr_tpu_torch.models import drop
from lwdetr_tpu_torch.models import transformer as ttr
from lwdetr_tpu_torch.models.lwdetr import LWDETR
from lwdetr_tpu_torch.parallel import dist as pdist
from lwdetr_tpu_torch.parallel import mesh as pmesh
from lwdetr_tpu_torch.train import engine, optim
from lwdetr_tpu_torch.weights import (build_mapping, grads_from_jax, read_jax_npz,
                                      state_dict_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(ROOT, "tests", "fixtures", "micro_map")

CFG = ModelConfig(
    encoder="vit_tiny", vit_encoder_num_layers=2, window_block_indexes=(0,),
    out_feature_indexes=(0, 1), projector_scale=("P4",), hidden_dim=64, dim_feedforward=128,
    sa_nheads=4, ca_nheads=8, dec_n_points=2, dec_layers=2, group_detr=3, num_queries=16,
    num_classes=7, two_stage=True, bbox_reparam=True, lite_refpoint_refine=True,
    drop_path=0.1, dropout=0.1)
TCFG = TrainConfig(ia_bce_loss=True, cls_loss_coef=1.0, use_ema=True, lr=2e-4, lr_encoder=3e-4,
                   lr_component_decay=0.7, max_gt=8)
IMG, GLOBAL, WORLD, STEPS = 128, 4, 2, 2
RATES = [float(r) for r in optim.drop_path_rates_for(CFG.drop_path, CFG.vit_encoder_num_layers)]
# against the JAX step: test_torch_port_train.py's bounds
JAX_LOSS_ATOL, JAX_GRAD_RTOL, BN_ATOL, ZERO_FLOOR = 1e-4, 1e-3, 1e-6, 1e-6
# against the port's one-process step
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4  # gradients: GRAD_TOL x max(1, the tensor's max |g|)
CHILD_TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(cmd, port, out_dir=None):
    """`cmd` in WORLD processes with torchrun's environment variables."""
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, PYTHONPATH=ROOT, WORLD_SIZE=str(WORLD), RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    return procs


def _wait(procs):
    """Each process's stdout; a process that fails or outlives CHILD_TIMEOUT
    fails the test, and no process is left running."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
            assert p.returncode == 0, f"process failed:\n{out[-3000:]}\n{err[-5000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


class Recorder:
    """numpy masks drawn from a seed at the shapes the sites ask for."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.masks = []

    def __call__(self, keep, shape, like):
        self.masks.append(self.rng.random(tuple(shape)) < float(keep))
        return torch.from_numpy(self.masks[-1]).to(like.dtype)


def _fake_bernoulli(masks):
    fed = iter(masks)

    def bernoulli(key, p, shape):
        m = next(fed)
        assert tuple(shape) == m.shape, (tuple(shape), m.shape)
        return jnp.asarray(m)

    return bernoulli


def _fake_top_k(picks):
    fed = iter(picks)

    def top_k(x, k):
        idx = jnp.asarray(next(fed))
        assert idx.shape == x.shape[:-1] + (k,)
        return jnp.take_along_axis(x, idx, axis=-1), idx

    return top_k


def _batch(rng):
    return {
        "images": rng.standard_normal((GLOBAL, IMG, IMG, 3)).astype(np.float32),
        "labels": rng.integers(0, CFG.num_classes, (GLOBAL, TCFG.max_gt)).astype(np.int32),
        "boxes": np.concatenate([rng.uniform(0.3, 0.7, (GLOBAL, TCFG.max_gt, 2)),
                                 rng.uniform(0.1, 0.4, (GLOBAL, TCFG.max_gt, 2))],
                                -1).astype(np.float32),
        "valid": np.arange(TCFG.max_gt)[None] < np.array([[3], [5], [1], [6]]),
    }


def _one_process(sd, batches, mask_source, steps):
    """The port's one-process step on the global batches: per step the
    metrics, the gradients before clipping and the BatchNorm statistics; the
    picks and matchings it made."""
    state = engine.create_train_state(CFG, TCFG, niter_per_ep=10, device="cpu", state_dict=sd)
    named = list(state.model.named_parameters())
    step = engine.build_train_step(state, cm.SetCriterion(CFG, TCFG), TCFG)
    picks, matchings, grads, records = [], [], [], []
    select, match, clip = ttr.select_proposals, cm.hungarian_match, torch.nn.utils.clip_grad_norm_

    def spy_select(scores, k):
        picks.append(select(scores, k))
        return picks[-1]

    def spy_match(*args, **kwargs):
        matchings.append(match(*args, **kwargs))
        return matchings[-1]

    def spy_clip(params, max_norm):
        grads.append({n: p.grad.clone() for n, p in named if p.grad is not None})
        return clip(params, max_norm)

    with mock.patch.object(ttr, "select_proposals", spy_select), \
            mock.patch.object(cm, "hungarian_match", spy_match), \
            mock.patch.object(torch.nn.utils, "clip_grad_norm_", spy_clip):
        for i in range(steps):
            tb = {k: torch.from_numpy(v) for k, v in batches[i].items()}
            metrics = step(tb, CFG.drop_path, CFG.dropout, mask_source)
            records.append({"metrics": {k: float(v) for k, v in metrics.items()},
                            "grads": grads[-1],
                            "bn": {k: v.clone() for k, v in state.model.state_dict().items()
                                   if k.endswith(("running_mean", "running_var"))}})
    return records, picks, matchings


def _jax_step(params, stats, batch, masks, matched, picks):
    """The JAX model's loss components, parameter gradients (in the port's
    names and layouts) and new BatchNorm statistics on the global batch."""
    jm = JaxModelConfig(**dataclasses.asdict(CFG))
    jt = JaxTrainConfig(**dataclasses.asdict(TCFG))
    jmodel, jcrit = jax_build_model(jm), JaxSetCriterion(jm, jt)
    jtargets = JaxTargets(jnp.asarray(batch["labels"]), jnp.asarray(batch["boxes"]),
                          jnp.asarray(batch["valid"]))
    jmatched = jnp.asarray(matched.numpy().astype(np.int32))

    def loss_fn(p):
        out, new = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(batch["images"]),
                                drop_path_rates=RATES, dropout_rate=CFG.dropout, train=True,
                                mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(2)})
        # the global batch's count: the JAX criterion's num_boxes
        num_boxes = jnp.maximum(jnp.sum(jtargets.valid.astype(jnp.float32)) * CFG.group_detr, 1.0)
        jsets = [(out, "", True)] + [(a, f"_{i}", False) for i, a in enumerate(out["aux_outputs"])]
        jsets.append((out["enc_outputs"], "_enc", False))
        jlosses = {}
        for i, (o, suffix, diag) in enumerate(jsets):
            jlosses.update(jcrit._loss_set(o, jtargets, num_boxes, CFG.group_detr, suffix=suffix,
                                           with_diag=diag, matched=jmatched[i]))
        total = sum(jlosses[k] * w for k, w in jcrit.weight_dict().items())
        return total, (jlosses, new["batch_stats"])

    with mock.patch.object(jax.random, "bernoulli", _fake_bernoulli(masks)), \
            mock.patch.object(jax.lax, "top_k", _fake_top_k([p.numpy() for p in picks])):
        (total, (jlosses, new_stats)), jgrads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    grads = grads_from_jax(jax.tree.map(lambda g: np.asarray(g, np.float32), jgrads), CFG)
    bn = state_dict_from_jax(params, jax.tree.map(np.asarray, new_stats), CFG)
    return (float(total), {k: float(v) for k, v in jlosses.items()}, grads,
            {k: v for k, v in bn.items() if k.endswith(("running_mean", "running_var"))})


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # as the processes: the suite's workers share the cores
    try:
        return _two_process(tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def _two_process(tmp_path_factory):
    jm = JaxModelConfig(**dataclasses.asdict(CFG))
    jmodel = jax_build_model(jm)
    variables = jax.jit(lambda rngs, x: jmodel.init(rngs, x, train=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, IMG, IMG, 3), jnp.float32))
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda l: np.asarray(l) + 0.02 * rng.standard_normal(l.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    sd = state_dict_from_jax(params, stats, CFG)
    batches = [_batch(rng) for _ in range(STEPS)]

    recorder = Recorder(5)
    one, picks, matchings = _one_process(sd, batches, recorder, STEPS)
    per_step = len(recorder.masks) // STEPS
    # the engine's own draw (no mask source): the one-process masks
    drawn = []
    call = drop.Bernoulli.__call__

    def record(self, keep, shape, like):
        drawn.append(call(self, keep, shape, like).clone())
        return drawn[-1]

    with mock.patch.object(drop.Bernoulli, "__call__", record):
        _one_process(sd, batches, None, 1)

    out_dir = tmp_path_factory.mktemp("dist")
    torch.save({"cfg": CFG, "tcfg": TCFG, "sd": sd, "batches": batches, "masks": recorder.masks,
                "picks": picks, "matchings": matchings, "drop_path": CFG.drop_path,
                "dropout": CFG.dropout}, out_dir / "inputs.pt")
    procs = _launch([sys.executable, os.path.join(ROOT, "tests", "torch_port_dist_child.py"),
                     str(out_dir)], _free_port())
    # the JAX step on the global batch while the processes run
    groups = CFG.group_detr
    jax_ref = _jax_step(params, stats, batches[0], recorder.masks[:per_step], matchings[0],
                        picks[:groups])
    _wait(procs)
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return dict(one=one, jax=jax_ref, ranks=ranks, drawn=drawn, masks=recorder.masks,
                per_step=per_step, sd=sd)


def _rel_errors(got, ref, top):
    return {n: ((got[n] - g).abs().max() / g.abs().max().clamp(min=ZERO_FLOOR * top)).item()
            for n, g in ref.items()}


def test_two_processes_run_ddp_and_every_fed_mask(two_process):
    for r, res in enumerate(two_process["ranks"]):
        assert (res["rank"], res["world"]) == (r, WORLD)
        assert res["ddp"] == "DistributedDataParallel"
        assert res["fed_used"] == len(two_process["masks"])
        assert res["any_process"] == [True, False]  # a stop on one rank stops both
    # DDP leaves every process the same averaged gradients, bit for bit
    g0, g1 = (res["steps"][0]["grads"] for res in two_process["ranks"])
    assert set(g0) == set(g1) and all(torch.equal(g0[n], g1[n]) for n in g0)


def test_the_two_process_step_matches_the_jax_step_on_the_global_batch(two_process):
    """Losses, every gradient and the BatchNorm statistics of the 2 x 2 step
    against JAX's on the 4 images. The mean of the processes' losses is the
    global loss: each divides its share by the global num_boxes over the
    world size, and DDP averages the gradients (a process dividing by the
    global count alone gives gradients half as large, which the per-tensor
    bound sees)."""
    jtotal, jlosses, jgrads, jbn = two_process["jax"]
    steps = [res["steps"][0] for res in two_process["ranks"]]
    # the loss components (the diagnostics class_error / cardinality_error are
    # each process's own ratios, averaged for the log as the reference does)
    losses = [k for k in jlosses if k.startswith("loss")]
    assert len(losses) == 3 * (CFG.dec_layers + 1)
    mean = {k: np.mean([s["metrics"][k] for s in steps]) for k in losses}
    for k in losses:
        assert mean[k] == pytest.approx(jlosses[k], abs=JAX_LOSS_ATOL), k
    assert np.mean([s["metrics"]["loss"] for s in steps]) == pytest.approx(jtotal,
                                                                          abs=JAX_LOSS_ATOL)
    assert steps[0]["metrics"]["loss"] != steps[1]["metrics"]["loss"]  # each process's share
    grads = steps[0]["grads"]
    top = max(g.abs().max().item() for g in jgrads.values())
    assert set(grads) == set(jgrads)
    rel = _rel_errors(grads, jgrads, top)
    worst = max(rel, key=rel.get)
    assert rel[worst] <= JAX_GRAD_RTOL, (worst, rel[worst])
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
    jnorm = torch.sqrt(sum(g.double().square().sum() for g in jgrads.values()))
    assert abs(norm / jnorm - 1) < 1e-3
    for k, v in jbn.items():
        for s in steps:
            np.testing.assert_allclose(s["bn"][k].numpy(), v.numpy(), atol=BN_ATOL, err_msg=k)


def test_the_two_process_step_matches_the_one_process_step(two_process):
    """Both steps, against the port's own step on the 4 images in one process:
    the loss within 1e-5 relative, each gradient within 1e-4 x max(1, max |g|),
    the BatchNorm statistics within 1e-6."""
    for i, one in enumerate(two_process["one"]):
        steps = [res["steps"][i] for res in two_process["ranks"]]
        loss = np.mean([s["metrics"]["loss"] for s in steps])
        assert loss == pytest.approx(one["metrics"]["loss"], rel=LOSS_RTOL)
        assert np.mean([s["metrics"]["grad_norm"] for s in steps]) == pytest.approx(
            one["metrics"]["grad_norm"], rel=LOSS_RTOL)
        for n, g in one["grads"].items():
            err = (steps[0]["grads"][n] - g).abs().max().item()
            assert err <= GRAD_TOL * max(1.0, g.abs().max().item()), (i, n, err)
        for k, v in one["bn"].items():
            for s in steps:
                np.testing.assert_allclose(s["bn"][k].numpy(), v.numpy(), atol=BN_ATOL, err_msg=k)


def test_zero1_equals_the_unsharded_step_bit_for_bit(two_process):
    """`--shard_opt_state`: after two steps the parameters, the EMA (gathered)
    and the optimizer state (gathered) equal the unsharded run's bit for bit;
    each process holds less optimizer state; the checkpoint holds the
    unsharded layout, written once, and a restore gives each process its
    slices back."""
    plan = pmesh.zero1_plan(LWDETR(CFG).state_dict(), WORLD, pmesh.jax_dim0(CFG))
    assert plan
    for res in two_process["ranks"]:
        assert res["planned"] == sorted(plan)
        for key in ("params", "ema"):
            a, b = res[f"{key}_a"], res[f"{key}_b"]
            assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a), key
        for opt in (res["opt_b"], res["saved_opt"], res["restored_opt"]):
            assert opt["param_groups"] == res["opt_a"]["param_groups"]
            for i, st in res["opt_a"]["state"].items():
                assert all(torch.equal(st[k], opt["state"][i][k]) for k in st), i
        assert all(torch.equal(res["saved_ema"][k], v) for k, v in res["ema_a"].items())
        assert res["restored_ema_slices_equal"] and res["restored_step"] == STEPS
        assert res["written_by"] == ["2.pth"]
        planned_bytes = 2 * 4 * sum(plan.values())  # two f32 moments a planned element
        assert res["opt_bytes_a"] - res["opt_bytes_b"] == planned_bytes // WORLD


def test_the_engines_masks_are_rows_of_one_global_draw(two_process):
    """Each process's masks are its rows of the one-process draw at the global
    batch's shape; an independent draw per process from the same seed would
    give both processes the same masks."""
    ref = two_process["drawn"]
    n = GLOBAL // WORLD
    ranks = [res["drawn_masks"] for res in two_process["ranks"]]
    assert len(ref) == two_process["per_step"] and all(len(m) == len(ref) for m in ranks)
    for r, masks in enumerate(ranks):
        for m, full in zip(masks, ref):
            assert torch.equal(m, full[r * m.shape[0]:(r + 1) * m.shape[0]])
    assert any(not torch.equal(a, b) for a, b in zip(*ranks))
    assert ranks[0][-1].shape[0] == n  # a (B, Q, C) site: one row an image


@pytest.fixture(scope="module")
def micro_pth(tmp_path_factory):
    from lwdetr_tpu_torch import main as cli

    args = cli.parser().parse_args(["--device", "cpu", *MICRO_FLAGS])
    cfg = cli.config_from_args(args).model
    tree = read_jax_npz(os.path.join(FIXDIR, "weights.npz"))
    path = tmp_path_factory.mktemp("micro") / "micro.pth"
    torch.save({"model": state_dict_from_jax(tree["params"], tree.get("batch_stats"), cfg)},
               path)
    return str(path)


MICRO_FLAGS = ("--encoder vit_tiny --vit_encoder_num_layers 2 --window_block_indexes 0 "
               "--out_feature_indexes 0 1 --projector_scale P4 --hidden_dim 64 "
               "--dim_feedforward 128 --sa_nheads 4 --ca_nheads 8 --dec_n_points 2 "
               "--dec_layers 2 --group_detr 2 --num_queries 12 --num_select 10 --two_stage "
               "--lite_refpoint_refine --bbox_reparam --square_resize_div_64 --max_gt 10").split()


def test_the_two_process_eval_cli_gives_the_golden_stats(micro_pth, tmp_path):
    """`python -m lwdetr_tpu_torch.main --eval` in 2 processes (torchrun's
    variables), batch 4 each: the merged detections' 12 stats equal
    `golden_stats.json` within 1e-7; rank 0 alone prints them and writes
    log.txt."""
    with open(os.path.join(FIXDIR, "golden_stats.json")) as f:
        golden = json.load(f)["stats"]
    cmd = [sys.executable, "-m", "lwdetr_tpu_torch.main", "--eval", "--device", "cpu",
           "--coco_path", FIXDIR, *MICRO_FLAGS, "--batch_size", "4", "--resume", micro_pth,
           "--output_dir", str(tmp_path), "--dont_bench", "--sync_bn"]
    outs = _wait(_launch(cmd, _free_port()))
    assert "distributed: process 0/2, backend gloo, device cpu" in outs[0]
    stats = json.loads(outs[0].strip().splitlines()[-1])
    for k in sorted(golden):
        np.testing.assert_allclose(stats[k], golden[k], atol=1e-7, rtol=0, err_msg=k)
    assert outs[1].strip() == ""  # rank 1 prints nothing
    assert "(10 images)" in outs[0]  # each process evaluated its share of the 20
    lines = (tmp_path / "log.txt").read_text().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert all(record[f"test_{k}"] == stats[k] for k in golden)


# -- in process -----------------------------------------------------------------------------------

ENVS = [
    {},
    {"WORLD_SIZE": "1"},
    {"WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "0", "MASTER_ADDR": "h", "MASTER_PORT": "9"},
    {"SLURM_NTASKS": "1"},
    {"SLURM_NTASKS": "8", "SLURM_PROCID": "5", "SLURM_LOCALID": "1", "MASTER_ADDR": "h"},
    {"SLURM_NTASKS": "2", "SLURM_PROCID": "1", "SLURM_LAUNCH_NODE_IPADDR": "10.0.0.1"},
    {"LWDETR_DIST": "1", "WORLD_SIZE": "2", "RANK": "1", "MASTER_ADDR": "h",
     "MASTER_PORT": "9"},
    {"LWDETR_DIST": "0", "WORLD_SIZE": "", "SLURM_NTASKS": ""},
    {"COORDINATOR_ADDRESS": "h:7", "NUM_PROCESSES": "2", "PROCESS_ID": "1"},
    {"COORDINATOR_ADDRESS": "h:7", "NUM_PROCESSES": "1", "PROCESS_ID": "0"},
    {"COORDINATOR_ADDRESS": "h:7", "NUM_PROCESSES": "3", "PROCESS_ID": "2", "WORLD_SIZE": "2",
     "RANK": "0", "MASTER_ADDR": "m", "MASTER_PORT": "1"},
]


@pytest.mark.parametrize("env", ENVS, ids=[",".join(sorted(e)) or "empty" for e in ENVS])
def test_the_launch_resolves_in_the_jax_order(env):
    """Explicit (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID) first, then a
    detected launch, then one process: the port's `resolve_launch` on the
    JAX package's environment dicts."""
    launch = pdist.resolve_launch(env)
    assert pdist.multiprocess_env_detected(env) == jdist._multiprocess_env_detected(env)
    explicit = bool(env.get("COORDINATOR_ADDRESS")) and int(env.get("NUM_PROCESSES", 0)) > 1
    if explicit:
        assert launch.init_method == f"tcp://{env['COORDINATOR_ADDRESS']}"
        assert (launch.rank, launch.world) == (int(env["PROCESS_ID"]), int(env["NUM_PROCESSES"]))
    elif jdist._multiprocess_env_detected(env):
        world = int(env.get("WORLD_SIZE") or env.get("SLURM_NTASKS"))
        rank = int(env.get("RANK") or env.get("SLURM_PROCID"))
        assert (launch.rank, launch.world) == (rank, world)
        assert launch.init_method.startswith("tcp://")
    else:
        assert launch is None


def test_explicit_arguments_come_before_the_environment():
    env = {"COORDINATOR_ADDRESS": "h:7", "NUM_PROCESSES": "4", "PROCESS_ID": "3"}
    launch = pdist.resolve_launch(env, coordinator="a:1", num_processes=2, process_id=0)
    assert (launch.rank, launch.world, launch.init_method) == (0, 2, "tcp://a:1")
    assert pdist.resolve_launch({}, "a:1", 1, 0) is None  # one process: nothing to start


def test_the_port_ignores_tpu_launch_signals_and_refuses_half_a_launch():
    """The JAX package also counts a multi-worker TPU slice; the port runs on
    no TPU. A detected launch it cannot resolve raises rather than train alone."""
    tpu = {"TPU_WORKER_HOSTNAMES": "a,b"}
    assert jdist._multiprocess_env_detected(tpu) and pdist.resolve_launch(tpu) is None
    with pytest.raises(ValueError, match="LWDETR_DIST"):
        pdist.resolve_launch({"LWDETR_DIST": "1"})
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        pdist.resolve_launch({"WORLD_SIZE": "2", "RANK": "0"})


@pytest.mark.parametrize("device,local_world,cards,backend", [
    ("cpu", 2, 0, "gloo"), ("cuda", 8, 8, "nccl"), ("cuda", 1, 1, "nccl"),
    ("cuda", 2, 1, "gloo"), ("cuda", None, 8, "nccl")])
def test_the_backend_rule(device, local_world, cards, backend):
    assert pdist.choose_backend(device, local_world, cards) == backend


@pytest.mark.parametrize("env,local_world,cards,backend", [
    # srun over two nodes without --ntasks-per-node: the tasks-per-node lists say 8
    ({"SLURM_NTASKS": "16", "SLURM_PROCID": "9", "SLURM_LOCALID": "1", "SLURM_NODEID": "1",
      "SLURM_TASKS_PER_NODE": "8(x2)", "MASTER_ADDR": "h"}, 8, 8, "nccl"),
    ({"SLURM_NTASKS": "7", "SLURM_PROCID": "6", "SLURM_LOCALID": "0", "SLURM_NODEID": "3",
      "SLURM_TASKS_PER_NODE": "4", "SLURM_STEP_TASKS_PER_NODE": "2(x3),1",
      "MASTER_ADDR": "h"}, 1, 1, "nccl"),
    ({"SLURM_NTASKS": "2", "SLURM_PROCID": "1", "SLURM_NODEID": "0",
      "SLURM_TASKS_PER_NODE": "2", "MASTER_ADDR": "h"}, 2, 1, "gloo"),
    # nothing counts the host's processes: unknown, not the world size
    ({"SLURM_NTASKS": "16", "SLURM_PROCID": "9", "MASTER_ADDR": "h"}, None, 8, "nccl"),
    ({"COORDINATOR_ADDRESS": "h:7", "NUM_PROCESSES": "16", "PROCESS_ID": "9"}, None, 8, "nccl"),
    ({"WORLD_SIZE": "16", "RANK": "9", "MASTER_ADDR": "h", "MASTER_PORT": "9"}, None, 8,
     "nccl"),
    ({"WORLD_SIZE": "16", "RANK": "9", "LOCAL_WORLD_SIZE": "8", "MASTER_ADDR": "h",
      "MASTER_PORT": "9"}, 8, 8, "nccl")])
def test_a_multi_node_launch_counts_the_hosts_processes(env, local_world, cards, backend):
    """The host's process count comes from LOCAL_WORLD_SIZE or SLURM's
    tasks-per-node lists, never the world size: a multi-node launch of one
    process a card takes nccl, also where nothing counts the host's processes;
    gloo only where a host's processes outnumber its cards."""
    launch = pdist.resolve_launch(env)
    assert launch.local_world == local_world
    assert pdist.choose_backend("cuda", launch.local_world, cards) == backend


def test_one_process_starts_no_group_and_reduces_nothing():
    assert pdist.init_distributed("cpu") == (0, 1) and not pdist.is_initialized()
    t = torch.ones(3)
    assert pdist.all_reduce_sum(t) is t and pdist.all_gather_objects(5) == [5]
    assert pdist.collective_device() == torch.device("cpu") and pdist.is_main_process()
    assert pdist.any_process(True) and not pdist.any_process(False)


def _jax_plan(cfg):
    """{reference key: sharded?} of the JAX ZeRO-1 plan over the params and
    batch_stats (the moments and the EMA) on a 2-device mesh, from the
    variables' shapes alone."""
    jm = JaxModelConfig(**dataclasses.asdict(cfg))
    jmodel = jax_build_model(jm)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 320, 320, 3), jnp.float32), train=True))
    mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
    specs = zero1_sharding_tree(mesh, {"params": shapes["params"],
                                       "batch_stats": shapes["batch_stats"]})
    out = {}
    for tk, coll, path, _ in build_mapping(cfg):
        node = specs[coll]
        for k in path:
            node = node[k]
        out[tk] = node.spec == jax.sharding.PartitionSpec("data")
    return out


@pytest.mark.parametrize("preset", ["nano", "small"])
def test_the_zero1_plan_takes_the_jax_packages_leaves(preset):
    """The planned leaves, by the reference's state_dict keys, against
    `zero1_sharding_tree` on a 2-device CPU mesh: the same rule (ndim >= 1, at
    least 16384 elements, dim 0 divisible by the world size) on the same
    leaves, dim 0 read on the JAX layout."""
    cfg = CFG if preset == "nano" else get_config("small")
    with torch.device("meta"):
        named = LWDETR(cfg).state_dict()
    plan = pmesh.zero1_plan(named, 2, pmesh.jax_dim0(cfg))
    ref = _jax_plan(cfg)
    assert set(plan) <= set(ref)
    assert {k for k, v in ref.items() if v} == set(plan)
    assert len(plan) > 4
    # a 3 x 3 or 1 x 1 convolution's JAX dim 0 is its kernel height: replicated there and here
    convs = [k for k in ref if k.endswith("conv.weight") and named[k].numel() >= 16384]
    assert convs and not set(convs) & set(plan)
    for k, n in plan.items():
        starts = [pmesh.shard_range(n, 2, r) for r in range(2)]
        assert starts == [(0, n // 2), (n // 2, n)]


def test_the_cli_passes_shard_opt_state_and_accepts_sync_bn(monkeypatch):
    """`--shard_opt_state` reaches the train state (ZeRO-1 above one process,
    nothing in one, as the JAX CLI's `n_data > 1`); `--sync_bn` parses and
    changes no setting: the statistics always span the global batch."""
    from lwdetr_tpu_torch import main as cli

    seen = {}

    def fake_state(*args, **kwargs):
        seen.update(kwargs)
        raise RuntimeError("stop here")

    monkeypatch.setattr(engine, "create_train_state", fake_state)
    base = ["--device", "cpu", "--coco_path", FIXDIR, *MICRO_FLAGS, "--dont_bench",
            "--output_dir", ""]
    with mock.patch("lwdetr_tpu_torch.data.coco.build_dataset",
                    side_effect=lambda split, dcfg: list(range(8))):
        with pytest.raises(RuntimeError, match="stop here"):
            cli.main(cli.parser().parse_args(base + ["--shard_opt_state", "--batch_size", "2"]))
    assert seen["shard_opt_state"] is True
    with_bn = cli.config_from_args(cli.parser().parse_args(base + ["--sync_bn"]))
    assert with_bn == cli.config_from_args(cli.parser().parse_args(base))
    monkeypatch.undo()
    one = engine.create_train_state(CFG, TCFG, niter_per_ep=1, device="cpu",
                                    shard_opt_state=True)
    assert one.shards is None and type(one.optimizer) is torch.optim.AdamW
