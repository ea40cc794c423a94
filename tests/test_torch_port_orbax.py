"""The port's reader of the JAX CLI's orbax train states, against orbax itself.

On the CPU: the zstd decoder (`csrc/zstd_decode.cpp`) against `zstandard`;
`train/orbax_read.py` against `ocp.CheckpointManager(...).restore`, bit for
bit, on trees the JAX package's `save_checkpoint` writes here and on the
committed fixture `tests/fixtures/micro_orbax/` (made by the JAX CLI,
`tests/gen_micro_orbax_fixture.py`), and its OCDBT layer against
tensorstore's on a store whose small nodes make interior nodes; the port's
restored train state against the JAX one through the weights' mapping, and
one optimizer step on the same gradients against the optax chain; the eval
CLI with `--resume` of the fixture against `golden_stats_orbax.json` (both
blocks), the train CLI's resume and the demo; and what the reader refuses.
"""
import dataclasses
import hashlib
import json
import os
import shutil
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lwdetr_tpu.train import checkpoint as jckpt
from lwdetr_tpu.train import optim as joptim
from lwdetr_tpu_torch import demo as tdemo
from lwdetr_tpu_torch import main as cli
from lwdetr_tpu_torch.models.lwdetr import build_model
from lwdetr_tpu_torch.parallel import mesh
from lwdetr_tpu_torch.train import checkpoint as ckpt
from lwdetr_tpu_torch.train import engine, optim, orbax_read
from lwdetr_tpu_torch.utils import zstd
from lwdetr_tpu_torch.weights import grads_from_jax, param_tensors_from_jax, state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(ROOT, "tests", "fixtures", "micro_map")
ORBAX = os.path.join(ROOT, "tests", "fixtures", "micro_orbax")
CKPT = os.path.join(ORBAX, "ckpt")
GOLDEN_ATOL = 1e-7
OPT_ATOL = 1e-6  # tests/test_torch_port_train.py's bound on an optimizer step
NITER = 5  # the fixture's 20 images at batch 4: its step 5 ends epoch 0
# the micro model of tests/micro_map_common.py:30-41, as CLI flags
MICRO_FLAGS = ("--encoder vit_tiny --vit_encoder_num_layers 2 --window_block_indexes 0 "
               "--out_feature_indexes 0 1 --projector_scale P4 --hidden_dim 64 "
               "--dim_feedforward 128 --sa_nheads 4 --ca_nheads 8 --dec_n_points 2 "
               "--dec_layers 2 --group_detr 2 --num_queries 12 --num_select 10 --two_stage "
               "--lite_refpoint_refine --bbox_reparam --square_resize_div_64 --max_gt 10").split()

with open(os.path.join(ORBAX, "golden_stats_orbax.json")) as _f:
    GOLDEN = json.load(_f)
with open(os.path.join(ORBAX, "orbax_digests.json")) as _f:
    DIGESTS = json.load(_f)


def _args(*extra):
    return cli.parser().parse_args(["--device", "cpu", "--coco_path", FIXDIR, *MICRO_FLAGS,
                                    "--batch_size", "4", "--dont_bench", "--num_workers", "0",
                                    *extra])


def _cfgs(*extra):
    cfg = cli.config_from_args(_args("--use_ema", *extra))
    return cfg.model, cfg.train


# -- the zstd decoder ---------------------------------------------------------------------------


def _payload(kind: str, size: int) -> bytes:
    rng = np.random.default_rng(size + len(kind))
    if kind == "f32":
        return rng.standard_normal(size // 4).astype(np.float32).tobytes()
    if kind == "text":
        words = [b"orbax", b"zarr", b"chunk", b"ocdbt", b"manifest", b"the", b"of", b"leaf"]
        return b" ".join(words[i] for i in rng.integers(0, len(words), size))[:size]
    if kind == "runs":
        return b"".join(bytes([int(rng.integers(0, 4))]) * int(rng.integers(1, 4000))
                        for _ in range(size // 1000 + 1))[:size]
    if kind == "far":  # a match 1.5 MB back
        head = rng.bytes(min(size // 4, 200_000))
        return (head + rng.bytes(max(size - 2 * len(head), 0)) + head)[:size]
    return rng.bytes(size)


ZSTD_CASES = (
    [(kind, size, level, True, level % 2 == 1) for kind, size in
     (("f32", 2 << 20), ("text", 300_000), ("runs", 500_000), ("far", 1_600_000))
     for level in (1, 3, 9, 19)]
    + [("random", size, 3, content, check) for size in (0, 1, 100, 4096, 131_073)
       for content in (True, False) for check in (True, False)])


@pytest.mark.parametrize("kind,size,level,content,check", ZSTD_CASES,
                         ids=[f"{k}-{n}B-l{lv}-{'size' if c else 'nosize'}-"
                              f"{'sum' if s else 'nosum'}" for k, n, lv, c, s in ZSTD_CASES])
def test_the_decoder_equals_zstandard(kind, size, level, content, check):
    zs = pytest.importorskip("zstandard")
    data = _payload(kind, size)
    frame = zs.ZstdCompressor(level=level, write_content_size=content,
                              write_checksum=check).compress(data)
    assert zs.ZstdDecompressor().decompress(frame, max_output_size=len(data) + 1) == data
    assert zstd.decompress(frame, len(data) + 1) == data
    out = np.empty(len(data), np.uint8)
    assert zstd.decompress_into(frame, out).tobytes() == data
    with pytest.raises(zstd.ZstdError):  # a caller expecting another size refuses it
        zstd.decompress_into(frame, np.empty(len(data) + 1, np.uint8))


def test_streamed_concatenated_and_skippable_frames_decode():
    """What a streaming writer emits (no content size, not single-segment, a
    window descriptor), frames one after another, and a skippable frame."""
    zs = pytest.importorskip("zstandard")
    data = _payload("f32", 1 << 20) + _payload("text", 200_000)
    for level in (1, 19):
        cobj = zs.ZstdCompressor(level=level, write_checksum=True).compressobj()
        frame = cobj.compress(data) + cobj.flush()
        assert not frame[4] & 0x20  # not single-segment: a window descriptor
        assert zstd.decompress(frame, 1 << 24) == data
    a, b = _payload("runs", 70_000), _payload("text", 9_000)
    joined = (zs.ZstdCompressor(level=1).compress(a) + struct.pack("<II", 0x184D2A5E, 3) + b"xyz"
              + zs.ZstdCompressor(level=19, write_checksum=True).compress(b))
    assert zstd.decompress(joined, 1 << 20) == a + b
    with pytest.raises(zstd.ZstdError, match="truncated"):
        zstd.decompress(joined[:-3], 1 << 20)
    with pytest.raises(zstd.ZstdError, match="not a zstd frame"):
        zstd.decompress(joined + b"\x00\x01\x02\x03", 1 << 20)
    with pytest.raises(zstd.ZstdError, match="larger than the expected"):
        zstd.decompress(joined, 1000)


def test_a_flipped_byte_raises_where_zstandard_raises():
    """Bytes of a checksummed frame flipped one at a time, header, blocks and
    checksum: the decoder raises wherever `zstandard` does, and every flip it
    decodes `zstandard` decodes to the same bytes (a bit no decoder reads)."""
    zs = pytest.importorskip("zstandard")
    data = _payload("text", 40_000) + _payload("f32", 40_000)
    frame = zs.ZstdCompressor(level=3, write_checksum=True).compress(data)
    raised = 0
    for pos in list(range(4, len(frame), 7)) + list(range(len(frame) - 4, len(frame))):
        bad = bytearray(frame)
        bad[pos] ^= 1 << (pos % 8)
        try:
            ref = zs.ZstdDecompressor().decompress(bytes(bad), max_output_size=len(data) + 1)
        except zs.ZstdError:
            ref = None
        if ref is None:
            raised += 1
            with pytest.raises(zstd.ZstdError):
                zstd.decompress(bytes(bad), len(data) + 1)
        else:
            assert zstd.decompress(bytes(bad), len(data) + 1) == ref == data, pos
    assert raised > 0.9 * len(frame) / 7


def test_crc32c_and_xxh64_known_values():
    assert zstd.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    assert zstd.crc32c(b"") == 0
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B


# -- the reader against orbax ------------------------------------------------------------------


def _compare(mine, ref, path="tree"):
    """`mine` (the port's reader) equals `ref` (orbax's restore) bit for bit."""
    if isinstance(ref, dict):
        assert isinstance(mine, dict) and set(mine) == set(ref), (path, sorted(mine), sorted(ref))
        for k in ref:
            _compare(mine[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(mine, list) and len(mine) == len(ref), path
        for i, (a, b) in enumerate(zip(mine, ref)):
            _compare(a, b, f"{path}/{i}")
    elif ref is None:
        assert mine is None, path
    else:
        ref = np.asarray(ref)
        assert isinstance(mine, np.ndarray), path
        assert (mine.dtype, mine.shape) == (ref.dtype, ref.shape), path
        assert mine.tobytes() == ref.tobytes(), path


def _orbax_restore(path):
    import orbax.checkpoint as ocp

    mgr = ocp.CheckpointManager(os.path.abspath(path))
    return mgr.restore(mgr.latest_step())


def _tree(kind: str):
    rng = np.random.default_rng(5)
    if kind == "small_leaves":  # 3000 leaves of a few floats
        return {f"leaf_{i:04d}": rng.standard_normal((i % 5 + 1, 3)).astype(np.float32)
                for i in range(3000)}
    params = {"dense": {"kernel": jnp.asarray(rng.standard_normal((640, 1100)), jnp.float32),
                        "bias": jnp.asarray(rng.standard_normal(1100), jnp.float32)},
              "c.d": {"k": jnp.arange(12, dtype=jnp.int32).reshape(3, 4)}}
    tx = optax.chain(optax.clip_by_global_norm(0.1), optax.scale_by_adam())
    return {"params": params, "opt_state": tx.init(params), "ema": None, "empty": {},
            "step": jnp.asarray(7, jnp.int32), "seq": [jnp.zeros((2,), jnp.float32),
                                                       {"x": jnp.ones((), jnp.float32)}]}


@pytest.mark.parametrize("kind", ["nested", "small_leaves"])
def test_the_reader_restores_what_orbax_restores(kind, tmp_path):
    """A multi-MB leaf (stored out of line in a data file), an int32 scalar,
    nesting, a dotted key, optax's chain (a tuple and NamedTuples), None and
    an empty dict; 3000 small leaves."""
    jckpt.save_checkpoint(str(tmp_path / "ckpt"), 7, _tree(kind), block=True)
    jckpt.wait_for_checkpoints()
    mine = orbax_read.restore(str(tmp_path / "ckpt"))
    assert mine.step == 7
    _compare(mine, _orbax_restore(tmp_path / "ckpt"))
    if kind == "nested":
        store = orbax_read.OcdbtStore(str(tmp_path / "ckpt" / "7" / "default"))
        out_of_line = [k for k, v in store.values.items() if not isinstance(v, bytes)]
        assert "params.dense.kernel/0.0" in out_of_line
        store.close()


def test_the_ocdbt_layer_reads_interior_nodes_as_tensorstore_does(tmp_path):
    """A store written by tensorstore with nodes of at most 1500 bytes: a
    b-tree of interior nodes over leaves, values inline and out of line."""
    ts = pytest.importorskip("tensorstore")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": {"max_decoded_node_bytes": 1500,
                                     "max_inline_value_bytes": 100}}).result()
    rng = np.random.default_rng(2)
    with ts.Transaction() as txn:
        for i in range(3000):
            kv.with_transaction(txn)[f"k/{i:05d}/{'x' * (i % 4)}"] = rng.bytes(
                int(rng.integers(0, 300)))
    store = orbax_read.OcdbtStore(str(tmp_path))
    keys = [k.decode() for k in kv.list().result()]
    assert sorted(store.values) == sorted(keys) and len(keys) == 3000
    for k in keys:
        assert bytes(store.get(k)) == kv.read(k).result().value, k
    assert store.root_height >= 2  # interior nodes over interior nodes
    assert any(not isinstance(v, bytes) for v in store.values.values())
    store.close()


ZARR_CASES = [("<f4", {"id": "zstd", "level": 1}, 5.5), ("<i4", None, None),
              ("<f8", {"id": "zstd", "level": 3}, None), ("|u1", None, 7)]


@pytest.mark.parametrize("dtype,compressor,fill", ZARR_CASES,
                         ids=[f"{d[1:]}-{'zstd' if c else 'raw'}" for d, c, _ in ZARR_CASES])
def test_zarr_arrays_of_several_chunks_read_as_tensorstore_reads_them(dtype, compressor, fill,
                                                                      tmp_path):
    """Chunks cropped at the edges, a chunk never written (the fill value, or
    zeros for a null one), a scalar; zstd or no compressor."""
    ts = pytest.importorskip("tensorstore")
    kv = {"driver": "ocdbt", "base": f"file://{tmp_path}"}
    rng = np.random.default_rng(4)
    for name, shape, chunks in (("grid", [7, 10], [3, 4]), ("scalar", [], [])):
        arr = ts.open({"driver": "zarr", "kvstore": kv, "path": name,
                       "metadata": {"shape": shape, "chunks": chunks, "dtype": dtype,
                                    "compressor": compressor, "fill_value": fill}},
                      create=True).result()
        data = (rng.standard_normal(shape) * 50).astype(np.dtype(dtype))
        if shape:
            arr[:6, :].write(data[:6]).result()  # the last row of chunks stays unwritten
        else:
            arr.write(data).result()
    store = orbax_read.OcdbtStore(str(tmp_path))
    assert "grid/2.0" not in store.values and "grid/1.2" in store.values
    for name in ("grid", "scalar"):
        want = ts.open({"driver": "zarr", "kvstore": kv, "path": name}).result().read().result()
        got, nread = orbax_read.read_zarr(store, name)
        assert got.dtype == want.dtype and got.shape == want.shape and nread > 0
        assert got.tobytes() == np.asarray(want).tobytes(), name
    grid = orbax_read.read_zarr(store, "grid")[0]
    assert grid[6:].tolist() == np.full((1, 10), fill or 0, np.dtype(dtype)).tolist()
    store.close()


# -- the committed fixture ------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


@pytest.fixture(scope="module")
def restored():
    return orbax_read.restore(CKPT)


def test_the_fixture_restores_to_its_digests(restored):
    got = [{"path": list(p), "dtype": a.dtype.str, "shape": list(a.shape),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()} for p, a in _leaves(restored)]
    assert restored.step == DIGESTS["step"] == 5
    assert got == DIGESTS["leaves"]
    assert restored.bytes_decoded == sum(a.nbytes for _, a in _leaves(restored))
    assert 15e6 < restored.bytes_read < restored.bytes_decoded


def test_the_fixture_restores_as_orbax_restores_it(restored):
    _compare(restored, _orbax_restore(CKPT))


@pytest.mark.parametrize("use_ema", [False, True], ids=["model", "ema"])
def test_load_orbax_variables_equals_the_jax_packages(use_ema):
    mcfg, _ = _cfgs()
    ref = jckpt.load_orbax_variables(CKPT, use_ema=use_ema)
    want = state_dict_from_jax(jax.tree.map(np.asarray, ref["params"]),
                               jax.tree.map(np.asarray, ref["batch_stats"]), mcfg)
    got = ckpt.load_orbax_variables(CKPT, mcfg, use_ema=use_ema)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    other = ckpt.load_orbax_variables(CKPT, mcfg, use_ema=not use_ema)
    assert not all(torch.equal(other[k], want[k]) for k in want if k.endswith("weight"))


# -- the train state ------------------------------------------------------------------------------


def _port_state(mcfg, tcfg, shards=None):
    model = build_model(mcfg, device="cpu", train=True,
                               generator=torch.Generator().manual_seed(0))
    optimizer, scheduler = optim.build_optimizer(model, mcfg, tcfg, NITER, shards)
    ema = optim.ema_init(model, shards) if tcfg.use_ema else None
    return engine.TrainState(model, optimizer, scheduler, ema, shards=shards)


@pytest.fixture(scope="module")
def jax_tree():
    return jax.tree.map(np.asarray, _orbax_restore(CKPT))


def test_the_restored_train_state_is_the_jax_one(jax_tree, restored):
    mcfg, tcfg = _cfgs()
    state = _port_state(mcfg, tcfg)
    assert ckpt.restore_orbax_train_state(CKPT, state, mcfg, restored) == 5 == state.step
    model = state_dict_from_jax(jax_tree["params"], jax_tree["batch_stats"], mcfg)
    ema = state_dict_from_jax(jax_tree["ema"]["params"], jax_tree["ema"]["batch_stats"], mcfg)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, model[k]), k
        assert torch.equal(state.ema[k], ema[k]), k
    adam, sched = jax_tree["opt_state"][1], jax_tree["opt_state"][2]
    mu, nu = param_tensors_from_jax(adam["mu"], mcfg), param_tensors_from_jax(adam["nu"], mcfg)
    names = optim.optimizer_param_names(state.optimizer, state.model)
    named = dict(state.model.named_parameters())
    assert set(names) == set(named) == set(mu)
    for name in names:
        st = state.optimizer.state[named[name]]
        assert torch.equal(st["exp_avg"], mu[name]) and torch.equal(st["exp_avg_sq"], nu[name])
        assert float(st["step"]) == int(adam["count"]) == 5
    assert state.scheduler.last_epoch == int(sched["count"]) == 5
    # the next step's lr: the JAX schedule's multiplier at the count, times each group's lr
    mult = float(joptim.step_lr_schedule(tcfg.lr_drop, NITER)(jnp.asarray(5)))
    for g in state.optimizer.param_groups:
        assert g["lr"] == pytest.approx(g["initial_lr"] * mult, rel=1e-12)


def test_one_optimizer_step_from_the_restored_state_matches_optax(jax_tree, restored):
    """The same gradients through the optax chain from the restored JAX
    state and through the port's AdamW from the restored port state."""
    mcfg, tcfg = _cfgs()
    jparams = jax_tree["params"]
    jm, jt = _jax_cfgs(mcfg, tcfg)
    tx = joptim.build_optimizer(jparams, jm, jt, niter_per_ep=NITER)
    init = tx.init(jparams)
    adam = jax_tree["opt_state"][1]
    opt_state = (init[0], init[1]._replace(count=jnp.asarray(adam["count"]), mu=adam["mu"],
                                           nu=adam["nu"]),
                 init[2]._replace(count=jnp.asarray(jax_tree["opt_state"][2]["count"])))
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 10.0 ** rng.integers(-4, 1)
                                    ).astype(np.float32), jparams)
    updates, _ = jax.jit(tx.update)(grads, opt_state, jparams)
    ref = state_dict_from_jax(jax.tree.map(np.asarray, optax.apply_updates(jparams, updates)),
                              jax_tree["batch_stats"], mcfg)

    state = _port_state(mcfg, tcfg)
    ckpt.restore_orbax_train_state(CKPT, state, mcfg, restored)
    named = dict(state.model.named_parameters())
    for name, g in grads_from_jax(grads, mcfg).items():
        named[name].grad = g
    torch.nn.utils.clip_grad_norm_(list(named.values()), tcfg.clip_max_norm)
    state.optimizer.step()
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=OPT_ATOL,
                                   err_msg=name)


def _jax_cfgs(mcfg, tcfg):
    from lwdetr_tpu.config import ModelConfig as JM
    from lwdetr_tpu.config import TrainConfig as JT

    return JM(**dataclasses.asdict(mcfg)), JT(**dataclasses.asdict(tcfg))


def test_a_zero1_state_takes_its_slices(restored):
    """Process 1 of 2 under ZeRO-1: its slices of the moments and the EMA."""
    mcfg, tcfg = _cfgs()
    model = build_model(mcfg, device="cpu", train=True,
                               generator=torch.Generator().manual_seed(0))
    named = model.state_dict()
    plan = mesh.zero1_plan(named, 2, mesh.jax_dim0(mcfg))
    shards = {k: (*mesh.shard_range(n, 2, 1), tuple(named[k].shape)) for k, n in plan.items()}
    assert shards
    state = _port_state(mcfg, tcfg, shards)
    ckpt.restore_orbax_train_state(CKPT, state, mcfg, restored)
    full = _port_state(mcfg, tcfg)
    ckpt.restore_orbax_train_state(CKPT, full, mcfg, restored)
    opt = {id(view): (p, start) for p, view, start in state.optimizer._sharded}
    names = optim.optimizer_param_names(state.optimizer, state.model)
    flat = [t for g in state.optimizer.param_groups for t in g["params"]]
    full_named = dict(full.model.named_parameters())
    checked = 0
    for name, t in zip(names, flat):
        want = full.optimizer.state[full_named[name]]["exp_avg"].reshape(-1)
        if id(t) in opt:
            start = opt[id(t)][1]
            want = want[start:start + t.numel()]
            checked += 1
        assert torch.equal(state.optimizer.state[t]["exp_avg"].reshape(-1), want), name
    assert checked == len([k for k in shards if k in full_named])
    for k, (start, stop, _) in shards.items():
        assert torch.equal(state.ema[k], full.ema[k].reshape(-1)[start:stop]), k


# -- the CLI and the demo -------------------------------------------------------------------------


def test_the_eval_cli_gives_the_golden_stats_of_both_blocks(tmp_path, capsys):
    out = cli.main(_args("--eval", "--resume", CKPT, "--use_ema", "--output_dir", str(tmp_path)))
    for key, block in (("stats", out["stats"]), ("ema_stats", out["ema_stats"])):
        off = {k: abs(block[k] - v) for k, v in GOLDEN[key].items()}
        assert max(off.values()) <= GOLDEN_ATOL, (key, off)
    # the EMA scores (the trained model's own AP is near 0: see the generator)
    assert GOLDEN["ema_stats"]["AP"] > 0.1 and 0 < GOLDEN["stats"]["AR100"]
    assert "resumed from" in capsys.readouterr().out


def test_the_train_cli_resumes_at_the_jax_step(monkeypatch, tmp_path, restored):
    """`--resume` of the fixture with 1 epoch to run: training starts at
    epoch 1 (step 5 // 5 steps an epoch), the state is the JAX one; the
    epoch's steps are held by `orbax_phase` on the card."""
    coco = tmp_path / "coco"
    (coco / "annotations").mkdir(parents=True)
    for split in ("train2017", "val2017"):
        os.symlink(os.path.join(FIXDIR, "val2017"), coco / split)
        shutil.copy(os.path.join(FIXDIR, "annotations", "instances_val2017.json"),
                    coco / "annotations" / f"instances_{split}.json")
    seen = {}

    def one_epoch(train_step, state, loader, epoch, *a, **k):
        seen.update(epoch=epoch, step=state.step, lr=[g["lr"] for g in state.optimizer.param_groups])
        return {}

    monkeypatch.setattr(engine, "train_one_epoch", one_epoch)
    args = _args("--resume", CKPT, "--use_ema", "--epochs", "2", "--coco_path", str(coco),
                 "--output_dir", str(tmp_path / "out"))
    out = cli.main(args)
    assert seen["epoch"] == 1 and seen["step"] == 5
    mcfg, tcfg = _cfgs()
    ref = _port_state(mcfg, tcfg)
    ckpt.restore_orbax_train_state(CKPT, ref, mcfg, restored)
    assert seen["lr"] == [g["lr"] for g in ref.optimizer.param_groups]
    assert out["epochs"] == [1]


def test_the_demo_reads_the_orbax_directory(monkeypatch, tmp_path):
    """`--checkpoint <ckpt dir> --ema` against the demo on a .pth of the same
    EMA weights (the micro model has no preset: both take its config)."""
    from lwdetr_tpu_torch import config as tconfig

    mcfg, _ = _cfgs()
    monkeypatch.setattr(tconfig, "get_config", lambda preset: mcfg)
    image = os.path.join(FIXDIR, "val2017", "000000000001.jpg")
    pth = tmp_path / "ema.pth"
    torch.save({"model": ckpt.load_orbax_variables(CKPT, mcfg, use_ema=True)}, pth)
    base = ["--device", "cpu", "--image", image, "--size", "256", "--threshold", "0.0"]
    a = tdemo.main(base + ["--checkpoint", CKPT, "--ema", "--output", str(tmp_path / "a.jpg")])
    b = tdemo.main(base + ["--checkpoint", str(pth), "--output", str(tmp_path / "b.jpg")])
    c = tdemo.main(base + ["--checkpoint", os.path.join(CKPT, "5"),
                           "--output", str(tmp_path / "c.jpg")])
    for key in ("scores", "labels", "boxes"):
        assert np.array_equal(a[key], b[key]), key
    assert not np.array_equal(a["scores"], c["scores"])  # the model's own weights differ


# -- refusals -------------------------------------------------------------------------------------


def _linked_copy(tmp_path):
    """The fixture's ckpt/ with its files linked; `_own` makes one a copy to edit."""
    dst = tmp_path / "ckpt"
    shutil.copytree(CKPT, dst, copy_function=os.symlink)
    return dst


def _own(path):
    target = os.path.realpath(path)
    os.remove(path)
    shutil.copy(target, path)
    return path


def _edit_metadata(dst, **changes):
    meta_path = _own(dst / "5" / "default" / "_METADATA")
    meta = json.loads(meta_path.read_text())
    meta.update(changes)
    meta_path.write_text(json.dumps(meta))


@pytest.mark.parametrize("change,match", [({"use_zarr3": True}, "use_zarr3"),
                                          ({"use_ocdbt": False}, "use_ocdbt")],
                         ids=["zarr3", "no_ocdbt"])
def test_the_reader_refuses_what_it_does_not_read(change, match, tmp_path):
    dst = _linked_copy(tmp_path)
    _edit_metadata(dst, **change)
    with pytest.raises(orbax_read.OrbaxFormatError, match=match):
        orbax_read.restore(str(dst))


@pytest.mark.parametrize("which", ["manifest", "node"])
def test_a_crc_mismatch_raises(which, tmp_path):
    dst = _linked_copy(tmp_path)
    item = dst / "5" / "default"
    path = item / "manifest.ocdbt" if which == "manifest" else next((item / "d").iterdir())
    _own(path)
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0x10
    path.write_bytes(bytes(raw))
    with pytest.raises(orbax_read.OrbaxFormatError, match="CRC-32C"):
        orbax_read.restore(str(dst))


def test_unfinished_steps_are_skipped(tmp_path):
    dst = _linked_copy(tmp_path)
    shutil.copytree(dst / "5", dst / "9.orbax-checkpoint-tmp-1792", copy_function=os.symlink)
    (dst / "12").mkdir()  # no _CHECKPOINT_METADATA: not finished
    assert orbax_read.step_directory(str(dst)) == (str(dst / "5"), 5)
    assert ckpt.checkpoint_file(str(dst)) == str(dst / "5")
    assert orbax_read.restore(str(dst / "5")).step == 5
    with pytest.raises(FileNotFoundError):
        orbax_read.step_directory(str(tmp_path))


@pytest.mark.parametrize("flags,leaf", [
    (["--dec_layers", "1"], "extra leaf params/transformer/layers_1/"),
    (["--dim_feedforward", "64"], "leaf params/transformer/layers_0/linear1/bias has shape")],
    ids=["extra_leaf", "shape"])
def test_a_tree_that_is_not_the_models_raises_naming_the_leaf(flags, leaf, tmp_path):
    with pytest.raises(ValueError, match=leaf):
        cli.main(_args("--eval", "--resume", CKPT, *flags, "--output_dir", str(tmp_path)))
    mcfg, tcfg = _cfgs(*flags)
    with pytest.raises(ValueError, match="does not match the model"):
        ckpt.restore_orbax_train_state(CKPT, _port_state(mcfg, tcfg), mcfg)


def test_a_port_checkpoint_directory_still_reads_as_before(tmp_path):
    """`read_checkpoint` tells a `.pth` directory from an orbax one."""
    d = tmp_path / "port_ckpt"
    d.mkdir()
    torch.save({"model": {}, "step": 3}, d / "3.pth")
    assert ckpt.checkpoint_file(str(d)) == str(d / "3.pth")
    assert ckpt.read_checkpoint(str(d)) == {"model": {}, "step": 3}
    assert not orbax_read.is_orbax_checkpoint(str(d)) and orbax_read.is_orbax_checkpoint(CKPT)
    assert ckpt.is_orbax_tree(ckpt.read_checkpoint(CKPT))
