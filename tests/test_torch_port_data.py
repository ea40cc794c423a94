"""The port's data pipeline against the JAX package's, on the CPU.

Datasets, targets, transforms, the native preprocessing and the batch loader
of `lwdetr_tpu_torch/data/` against `lwdetr_tpu/data/` on the mAP fixture
(`tests/fixtures/micro_map/`) and on small synthetic COCO dirs built as
`tests/test_data_pipeline.py::coco_dir` builds them: every batch equal bit for
bit (tolerance: none), eval with the fused native path and with PIL's, f32 and
bf16 images, train with a seed in each recipe. Also the port's own copies of
the config, logging and Objects365 remap modules.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
from lwdetr_tpu import config as jconfig
from lwdetr_tpu.data import coco as jcoco
from lwdetr_tpu.data import loader as jloader
from lwdetr_tpu.data import native as jnative
from lwdetr_tpu.utils import logging as jlogging
from lwdetr_tpu.utils import obj365_remap as jremap
from lwdetr_tpu_torch import config as pconfig
from lwdetr_tpu_torch.data import coco as pcoco
from lwdetr_tpu_torch.data import loader as ploader
from lwdetr_tpu_torch.data import native as pnative
from lwdetr_tpu_torch.ops import _build
from lwdetr_tpu_torch.utils import logging as plogging
from lwdetr_tpu_torch.utils import obj365_remap as premap

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "micro_map")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_coco(root, split, n_images, seed, png_every=0, cmyk_every=0):
    """A COCO-format dir: random JPEGs (some PNG / CMYK JPEG when asked) and
    1-3 random boxes each, categories 1-3, one crowd box in image 1."""
    img_dir = root / split
    img_dir.mkdir(parents=True)
    (root / "annotations").mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    ann_id = 1
    for img_id in range(1, n_images + 1):
        w, h = int(rng.integers(200, 400)), int(rng.integers(150, 300))
        arr = rng.integers(0, 255, (h, w, 3), np.uint8)
        name = f"{img_id:012d}.jpg"
        if png_every and img_id % png_every == 0:
            name = f"{img_id:012d}.png"
            Image.fromarray(arr).save(img_dir / name)
        elif cmyk_every and img_id % cmyk_every == 0:
            Image.fromarray(arr).convert("CMYK").save(img_dir / name)
        else:
            Image.fromarray(arr).save(img_dir / name)
        images.append({"id": img_id, "file_name": name, "width": w, "height": h})
        for k in range(int(rng.integers(1, 4))):
            bw, bh = float(rng.uniform(20, w / 2)), float(rng.uniform(20, h / 2))
            x = float(rng.uniform(0, w - bw))
            y = float(rng.uniform(0, h - bh))
            annotations.append({
                "id": ann_id, "image_id": img_id, "category_id": int(rng.integers(1, 4)),
                "bbox": [x, y, bw, bh], "area": bw * bh,
                "iscrowd": int(img_id == 1 and k == 0)})
            ann_id += 1
    categories = [{"id": i, "name": f"c{i}"} for i in range(1, 4)]
    with open(root / "annotations" / f"instances_{split}.json", "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": categories}, f)


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    _write_coco(root, "val2017", 5, seed=0)
    _write_coco(root, "train2017", 6, seed=1)
    return str(root)


@pytest.fixture(scope="module")
def odd_dir(tmp_path_factory):
    """A val dir with a PNG and a CMYK JPEG: the fused path refuses both."""
    root = tmp_path_factory.mktemp("odd")
    _write_coco(root, "val2017", 6, seed=2, png_every=3, cmyk_every=4)
    return str(root)


def _datasets(root, split="val2017"):
    args = (os.path.join(root, split), os.path.join(root, "annotations", f"instances_{split}.json"))
    return jcoco.CocoDetection(*args), pcoco.CocoDetection(*args)


def assert_batches_equal(jbatches, pbatches):
    """Every entry equal bit for bit; bf16 images compared as their bits."""
    assert len(jbatches) == len(pbatches) > 0
    for jb, pb in zip(jbatches, pbatches):
        assert set(jb) == set(pb)
        for k in jb:
            a, b = np.asarray(jb[k]), pb[k]
            if isinstance(b, torch.Tensor):
                assert b.dtype == torch.bfloat16 and a.dtype == jnp.bfloat16, k
                a, b = a.view(np.uint16), b.view(torch.int16).numpy().view(np.uint16)
            assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=k)


EVAL_CASES = [(where, native, dtype) for where in ("fixture", "synthetic", "odd")
              for native in (True, False) for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("where,native,dtype", EVAL_CASES,
                         ids=[f"{w}-{'native' if n else 'pil'}-{d}" for w, n, d in EVAL_CASES])
def test_eval_batches_equal_the_jax_loaders(where, native, dtype, coco_dir, odd_dir):
    root = {"fixture": FIXDIR, "synthetic": coco_dir, "odd": odd_dir}[where]
    jds, pds = _datasets(root)
    kw = dict(batch_size=4, train=False, max_gt=10, square_div_64=True, use_native=native,
              num_workers=2, eval_size=640 if where == "fixture" else 256)
    jb = list(jloader.DetectionLoader(jds, image_dtype=jnp.bfloat16 if dtype == "bfloat16"
                                      else None, **kw))
    pb = list(ploader.DetectionLoader(pds, image_dtype=torch.bfloat16 if dtype == "bfloat16"
                                      else None, **kw))
    assert_batches_equal(jb, pb)


def test_legacy_eval_recipe_batches_equal_the_jax_loaders(coco_dir):
    jds, pds = _datasets(coco_dir)
    kw = dict(batch_size=2, train=False, max_gt=10, square_div_64=False, drop_last=False)
    assert_batches_equal(list(jloader.DetectionLoader(jds, **kw)),
                         list(ploader.DetectionLoader(pds, **kw)))


TRAIN_CASES = [("square_div_64", dict(square_div_64=True)),
               ("per_image_scales", dict(square_div_64=True, per_image_scales=True)),
               ("default_recipe", dict(square_div_64=False)),
               ("sharded", dict(square_div_64=True, process_index=1, process_count=2,
                                drop_last=False))]


@pytest.mark.parametrize("name,kw", TRAIN_CASES, ids=[c[0] for c in TRAIN_CASES])
def test_train_batches_equal_the_jax_loaders_for_a_seed(name, kw, coco_dir):
    jds, pds = _datasets(coco_dir, "train2017")
    common = dict(batch_size=2, train=True, max_gt=10, seed=7, num_workers=3, **kw)
    jl, pl = jloader.DetectionLoader(jds, **common), ploader.DetectionLoader(pds, **common)
    assert len(jl) == len(pl)
    for epoch in range(2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        assert_batches_equal(list(jl), list(pl))


def test_batches_do_not_depend_on_the_worker_count(coco_dir):
    _, pds = _datasets(coco_dir, "train2017")
    mk = lambda w: ploader.DetectionLoader(pds, batch_size=2, train=True, max_gt=10,  # noqa: E731
                                          seed=5, num_workers=w, per_image_scales=True)
    assert_batches_equal(list(mk(1)), list(mk(4)))


def test_a_failing_sample_raises_at_its_batch(coco_dir):
    """An error in the loader's thread reaches the caller, not a short epoch:
    the batch before the missing sample comes through, the sample's batch
    raises. (The sample goes missing before the epoch starts: the thread
    works ahead of the caller, so a change made after the first batch races
    with it.)"""
    _, pds = _datasets(coco_dir)
    loader = ploader.DetectionLoader(pds, batch_size=2, train=False, max_gt=10, eval_size=128)
    pds.coco.imgs[pds.ids[3]]["file_name"] = "missing.jpg"
    it = iter(loader)
    next(it)
    with pytest.raises(FileNotFoundError):
        list(it)


def test_to_device_on_the_cpu_keeps_every_value(coco_dir):
    _, pds = _datasets(coco_dir)
    batch = next(iter(ploader.DetectionLoader(pds, batch_size=2, train=False, max_gt=10,
                                              eval_size=128, image_dtype=torch.bfloat16)))
    dev = ploader.to_device(batch, "cpu")
    assert dev["image_id"] is batch["image_id"]
    assert dev["images"].dtype == torch.bfloat16 and torch.equal(dev["images"], batch["images"])
    for k in ("labels", "boxes", "valid", "orig_size"):
        assert isinstance(dev[k], torch.Tensor)
        np.testing.assert_array_equal(dev[k].numpy(), batch[k])


def test_bf16_images_round_to_nearest_even_as_ml_dtypes():
    """Host f32 -> bf16: PyTorch's cast gives ml_dtypes' bits, ties and
    subnormals included."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 3,
                        # halfway cases between two bf16 values, both parities
                        (np.arange(1, 200, dtype=np.uint32) << 16 | 0x8000).view(np.float32),
                        np.array([1e-40, -1e-40, 3.4e38, 0.0, -0.0], np.float32)])
    ours = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(ours, x.astype(jnp.bfloat16).view(np.uint16))


# -- datasets and targets ---------------------------------------------------------------------


def test_targets_equal_the_jax_packages(coco_dir):
    jds, pds = _datasets(coco_dir)
    assert jds.ids == pds.ids and len(jds) == len(pds)
    for i in range(len(jds)):
        (jimg, jt), (pimg, pt) = jds.load_raw(i), pds.load_raw(i)
        np.testing.assert_array_equal(np.asarray(jimg), np.asarray(pimg))
        assert set(jt) == set(pt)
        for k in jt:
            np.testing.assert_array_equal(jt[k], pt[k], err_msg=k)
    anns = [{"bbox": [5, 5, 10, 10], "category_id": 1, "area": 100},
            {"bbox": [5, 5, 0, 10], "category_id": 2, "area": 0},      # degenerate
            {"bbox": [-5, 2, 400, 10], "category_id": 3, "area": 4000},  # clipped
            {"bbox": [1, 1, 3, 3], "category_id": 1, "area": 9, "iscrowd": 1}]
    jt, pt = jcoco.convert_coco_target(anns, 50, 40, 7), pcoco.convert_coco_target(anns, 50, 40, 7)
    for k in jt:
        np.testing.assert_array_equal(jt[k], pt[k], err_msg=k)


@pytest.mark.parametrize("layout", ["coco", "o365"])
def test_build_dataset_reads_each_layout(layout, tmp_path, coco_dir):
    if layout == "o365":
        os.symlink(os.path.join(coco_dir, "val2017"), tmp_path / "val")
        os.symlink(os.path.join(coco_dir, "annotations", "instances_val2017.json"),
                   tmp_path / "objects365_minival5k.json")
        root = str(tmp_path)
    else:
        root = coco_dir
    dcfg = dataclasses.replace(pconfig.DataConfig(), coco_path=root, dataset_file=layout)
    jcfg = dataclasses.replace(jconfig.DataConfig(), coco_path=root, dataset_file=layout)
    pds, jds = pcoco.build_dataset("val", dcfg), jcoco.build_dataset("val", jcfg)
    assert (pds.img_folder, pds.ids) == (jds.img_folder, jds.ids)
    with pytest.raises(ValueError):
        pcoco.build_dataset("val", dataclasses.replace(dcfg, dataset_file="voc"))


# -- the native preprocessing -----------------------------------------------------------------


def test_native_decode_and_resize_equal_the_jax_packages_library():
    """The port decodes with Pillow's libjpeg and resizes in its own copy of
    the C++ filter; the JAX package decodes and resizes in one C call. The
    pixels and the normalized floats are the same bits on every fixture image
    (the 3200x2400 one included)."""
    assert jnative.available() and pnative.available()
    for name in sorted(os.listdir(os.path.join(FIXDIR, "val2017"))):
        path = os.path.join(FIXDIR, "val2017", name)
        with open(path, "rb") as f:
            data = f.read()
        np.testing.assert_array_equal(pnative.decode_jpeg(path), jnative.decode_jpeg(data))
        jarr, jh, jw = jnative.decode_resize_normalize(data, 640)
        parr, ph, pw = pnative.load_image_fast(path, 640)
        assert (ph, pw) == (jh, jw) and parr.dtype == np.float32
        np.testing.assert_array_equal(parr, jarr)


def test_native_refuses_what_libjpeg_does_not_decode_to_rgb(odd_dir):
    img_dir = os.path.join(odd_dir, "val2017")
    png = os.path.join(img_dir, "000000000003.png")
    cmyk = os.path.join(img_dir, "000000000004.jpg")
    assert pnative.load_image_fast(png, 64) is None
    with open(cmyk, "rb") as f:
        assert jnative.decode_jpeg(f.read()) is None
    assert pnative.decode_jpeg(cmyk) is None and pnative.load_image_fast(cmyk, 64) is None


def test_native_builds_from_the_checkout_and_a_failed_build_raises(tmp_path, monkeypatch):
    path = pnative.library_path()
    assert path.parent == _build.BUILD_DIR and (_build.CSRC / pnative.SOURCE).is_file()
    assert "native" not in path.parts and path.exists()
    (tmp_path / pnative.SOURCE).write_text("this is not C++\n")
    monkeypatch.setattr(pnative, "CSRC", tmp_path)
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(pnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pnative.available()


# -- config, logging, remap -------------------------------------------------------------------


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING else f.default_factory())
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("preset", ["tiny", "small", "medium", "large", "xlarge"])
def test_release_config_is_the_jax_packages(preset):
    assert _fields(pconfig.DataConfig) == _fields(jconfig.DataConfig)
    assert [f.name for f in dataclasses.fields(pconfig.Config)] == \
        [f.name for f in dataclasses.fields(jconfig.Config)]
    assert dataclasses.asdict(pconfig.release_config(preset)) == \
        dataclasses.asdict(jconfig.get_config(preset))


def test_metric_logging_is_the_jax_packages(tmp_path):
    rng = np.random.default_rng(0)
    jl, pl = jlogging.MetricLogger(), plogging.MetricLogger()
    for _ in range(30):
        vals = {"loss": float(rng.random()), "grad_norm": float(rng.random() * 5)}
        jl.update(**vals)
        pl.update(**vals)
    pl.synchronize_between_processes()  # one process: a no-op
    for k in ("loss", "grad_norm"):
        j, p = jl.meters[k], pl.meters[k]
        assert (p.median, p.avg, p.global_avg, p.value, p.count) == \
            (j.median, j.avg, j.global_avg, j.value, j.count)
    assert str(pl) == str(jl)
    seen = list(pl.log_every(range(5), 2, header="t", logger=lambda s: None))
    assert seen == list(range(5))
    best = plogging.BestMetricHolder(use_ema=True)
    assert best.update(0.2, 0) and not best.update(0.1, 1) and best.update(0.3, 2, is_ema=True)
    assert best.summary() == {"best_regular": 0.2, "best_ema": 0.3}
    assert plogging.is_main_process() and plogging.world_size() == 1
    plogging.write_log_line(str(tmp_path), {"a": 1})
    plogging.write_log_line(str(tmp_path), {"b": 2.5})
    lines = (tmp_path / "log.txt").read_text().splitlines()
    assert [json.loads(s) for s in lines] == [{"a": 1}, {"b": 2.5}]


def test_obj365_remap_is_the_jax_packages():
    rng = np.random.default_rng(0)
    cur = {"class_embed.weight": rng.standard_normal((91, 8)), "b": rng.standard_normal(3)}
    pre = {"class_embed.weight": rng.standard_normal((366, 8)), "b": rng.standard_normal(3)}
    keys = ["class_embed.weight", "b", "absent"]
    assert premap.COCO_IDS == jremap.COCO_IDS and premap.OBJ365_IDS == jremap.OBJ365_IDS
    ours, theirs = premap.remap_torch_state_dict(cur, pre, keys), \
        jremap.remap_torch_state_dict(cur, pre, keys)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
