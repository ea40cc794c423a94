"""The JAX CLI's orbax train-state directories, read without JAX, orbax or tensorstore.

Counterpart, on the read side, of `lwdetr_tpu/train/checkpoint.py:293-386`
(`load_orbax_variables`, `save_checkpoint`, `restore_checkpoint`): the JAX
CLI saves its `TrainState` with `ocp.CheckpointManager(...).save(step,
args=ocp.args.StandardSave(state))` into `<output_dir>/ckpt/<step>/`, and
`restore(path)` here returns the nested tree that
`ocp.CheckpointManager(path).restore(step)` returns, as numpy arrays, bit for
bit. What is on disk:

* `<step>/_CHECKPOINT_METADATA` marks a finished step; `<step>/default/` is
  the saved item.
* `default/_METADATA` (JSON): `tree_metadata`, one entry a leaf keyed by its
  key tuple, with each key's type (1 a sequence index, 2 a dict key or a
  NamedTuple field) and the value's type; `use_ocdbt` and `use_zarr3`.
  `default/array_metadatas/process_<n>` name each jax array (`param_name`:
  the keys joined with dots, the name of a numpy array too).
* An OCDBT key-value store (tensorstore's format, version 0) at `default/`:
  `manifest.ocdbt` and b-tree nodes in data files under `d/` and
  `ocdbt.process_<n>/d/`. Each manifest and node is a 4-byte big-endian magic,
  its length (u64 LE), a varint format version and compression, the (zstd)
  body, and a CRC-32C of every byte before it (u32 LE). The manifest holds the
  store's config, a table of data files and the versions, the newest with the
  reference (file, offset, length) of its b-tree root. A node holds its own
  table of data files (paths relative to the base path of the file the node
  was read from), its keys prefix-compressed in columns (all prefix lengths,
  then all suffix lengths, then the suffix bytes) and either its children
  (interior) or its values, inline or by reference into a data file
  (leaves).
* One zarr v2 array a leaf under the key `<param_name>/`: `.zarray` (JSON:
  dtype, shape, chunks, order C, zstd or no compressor) and one key a chunk
  (`0.0`, ...; `0` for a scalar), each a zstd frame of the whole chunk.

The zstd frames and the CRC-32C are decoded by the port's own library
(`utils/zstd.py`). Data files are mapped, and each value is decoded from its
(offset, length) in place. Not read, and refused by name: `use_zarr3`,
`use_ocdbt: false`, a numbered manifest (tensorstore's distributed
coordinator), dictionaries, a zarr order F or filters, bfloat16 arrays. A
malformed file raises, naming the file or the key.
"""
from __future__ import annotations

import json
import mmap
import os
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from lwdetr_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
ITEM = "default"
STEP_METADATA = "_CHECKPOINT_METADATA"
EMPTY_ROOT = (1 << 64) - 1  # the offset / length of an empty tree's root
MANIFEST_LIMIT = 1 << 28    # decoded bytes a manifest may take
KEY_SEQUENCE, KEY_DICT = 1, 2
ARRAY_TYPES = ("jax.Array", "np.ndarray")
EMPTY_VALUES = {"None": lambda: None, "Dict": dict}  # optax's EmptyState; an empty dict


class OrbaxFormatError(ValueError):
    """A train-state directory this reader refuses, with the file or key at fault."""


# ---- steps ------------------------------------------------------------------------------------


def step_directory(path: str) -> Tuple[str, Optional[int]]:
    """(the step directory, its step) of `path`: `path` itself when it is a
    finished step (it holds `_CHECKPOINT_METADATA`), else the highest integer
    subdirectory of `path` that is one, as `CheckpointManager.latest_step()`
    picks it (unfinished `<step>.orbax-checkpoint-tmp-*` directories are not
    integers and are skipped)."""
    if os.path.isfile(os.path.join(path, STEP_METADATA)):
        name = os.path.basename(os.path.normpath(path))
        return path, int(name) if name.isdigit() else None
    steps = sorted(int(n) for n in os.listdir(path) if n.isdigit()
                   and os.path.isfile(os.path.join(path, n, STEP_METADATA))) \
        if os.path.isdir(path) else []
    if not steps:
        raise FileNotFoundError(f"no finished orbax checkpoint step under {path}")
    return os.path.join(path, str(steps[-1])), steps[-1]


def is_orbax_checkpoint(path: str) -> bool:
    """Whether `path` is an orbax step directory or a directory of them."""
    if not os.path.isdir(path):
        return False
    if os.path.isfile(os.path.join(path, STEP_METADATA)):
        return True
    return any(n.isdigit() and os.path.isfile(os.path.join(path, n, STEP_METADATA))
               for n in os.listdir(path))


# ---- byte reading -----------------------------------------------------------------------------


class _Cursor:
    def __init__(self, buf: bytes, what: str):
        self.buf, self.at, self.what = buf, 0, what

    def fail(self, msg: str):
        raise OrbaxFormatError(f"{self.what}: {msg}")

    def take(self, n: int) -> bytes:
        if n < 0 or self.at + n > len(self.buf):
            self.fail(f"truncated at byte {self.at} (wanted {n} more)")
        out = self.buf[self.at:self.at + n]
        self.at += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            if self.at >= len(self.buf):
                self.fail("truncated varint")
            b = self.buf[self.at]
            self.at += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _decode_file(buf, magic: int, what: str, limit: int) -> bytes:
    """The body of an OCDBT manifest or node: magic, length, version,
    compression and CRC-32C checked, the body decompressed."""
    if len(buf) < 18:
        raise OrbaxFormatError(f"{what}: {len(buf)} bytes is too short for an OCDBT file")
    head = bytes(buf[:12])
    got_magic, size = struct.unpack(">I", head[:4])[0], struct.unpack("<Q", head[4:12])[0]
    if got_magic != magic:
        raise OrbaxFormatError(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if size != len(buf):
        raise OrbaxFormatError(f"{what}: header gives {size} bytes, the file has {len(buf)}")
    want = struct.unpack("<I", bytes(buf[-4:]))[0]
    got = zstd.crc32c(memoryview(buf)[:-4])
    if got != want:
        raise OrbaxFormatError(f"{what}: CRC-32C {got:#010x} != stored {want:#010x}")
    cur = _Cursor(bytes(buf[12:min(len(buf) - 4, 32)]), what)
    version, compression = cur.varint(), cur.varint()
    if version != 0:
        raise OrbaxFormatError(f"{what}: OCDBT format version {version} (this reader reads 0)")
    body = memoryview(buf)[12 + cur.at:-4]
    if compression == 0:
        return bytes(body)
    if compression == 1:
        return zstd.decompress(body, limit, what=what)
    raise OrbaxFormatError(f"{what}: compression {compression} (0 none and 1 zstd are read)")


# ---- OCDBT --------------------------------------------------------------------------------------

class OcdbtStore:
    """An OCDBT store's newest version, every key resolved to its value's
    place. `get(key)` returns the value's bytes (a view of a mapped file for
    one stored out of line)."""

    def __init__(self, root: str):
        self.root = root
        self._maps: Dict[str, object] = {}
        # key -> its value's bytes (inline), or (data file path, offset, length)
        self.values: Dict[str, object] = {}
        self.root_height = -1  # of the newest version's b-tree; -1 when it is empty
        manifest = os.path.join(root, "manifest.ocdbt")
        if not os.path.isfile(manifest):
            if os.path.isfile(os.path.join(root, "manifest")):
                raise OrbaxFormatError(f"{root}: a numbered OCDBT manifest (tensorstore's "
                                       "coordinator) is not read")
            raise OrbaxFormatError(f"{root}: no OCDBT manifest (manifest.ocdbt)")
        with open(manifest, "rb") as f:
            raw = f.read()
        cur = _Cursor(_decode_file(raw, MANIFEST_MAGIC, manifest, MANIFEST_LIMIT), manifest)
        self._config(cur)
        files = self._file_table(cur, "")
        n = cur.varint()
        if n == 0:
            return  # no version: an empty store
        gens = cur.varints(n)
        heights = [cur.u8() for _ in range(n)]
        ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
        cur.varints(3 * n)  # statistics: keys, tree bytes, out-of-line bytes
        newest = int(np.argmax(gens))
        if offsets[newest] == EMPTY_ROOT:
            return
        self.root_height = heights[newest]
        self._walk(self._ref(files, ids[newest], offsets[newest], lengths[newest], manifest),
                   heights[newest], b"")

    def _config(self, cur: _Cursor) -> None:
        cur.take(16)  # uuid
        kind = cur.varint()
        if kind != 0:
            cur.fail(f"manifest kind {kind}: only a single manifest (0) is read, not a "
                     "numbered one")
        cur.varint()  # max inline value bytes
        self.max_node_bytes = cur.varint()
        cur.u8()  # version tree arity (log2)
        compression = cur.varint()
        if compression == 1:
            cur.take(4)  # zstd level, int32 LE
        elif compression != 0:
            cur.fail(f"config compression {compression}")

    def _file_table(self, cur: _Cursor, base: str) -> List[Tuple[str, str]]:
        """The data file table: (base path, relative path) of each file, the
        base paths below `base` (that of the file the table was read from)."""
        n = cur.varint()
        prefix = [0] + cur.varints(max(n - 1, 0))
        suffix = cur.varints(n)
        base_len = cur.varints(n)
        files, prev = [], b""
        for i in range(n):
            if prefix[i] > len(prev):
                cur.fail(f"data file {i}: prefix {prefix[i]} longer than the previous path")
            path = prev[:prefix[i]] + cur.take(suffix[i])
            if base_len[i] > len(path):
                cur.fail(f"data file {i}: base path longer than its path")
            text = path.decode()
            files.append((base + text[:base_len[i]], text[base_len[i]:]))
            prev = path
        return files

    def _ref(self, files, file_id: int, offset: int, length: int, what: str):
        if file_id >= len(files):
            raise OrbaxFormatError(f"{what}: data file {file_id} of a table of {len(files)}")
        base, rel = files[file_id]
        return base, base + rel, offset, length

    def _map(self, rel_path: str):
        mm = self._maps.get(rel_path)
        if mm is None:
            path = os.path.join(self.root, rel_path)
            if not os.path.isfile(path):
                raise OrbaxFormatError(f"{self.root}: missing data file {rel_path}")
            with open(path, "rb") as f:
                mm = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                      if os.fstat(f.fileno()).st_size else b"")
            self._maps[rel_path] = mm
        return mm

    def _slice(self, rel_path: str, offset: int, length: int, what: str) -> memoryview:
        mm = self._map(rel_path)
        if offset + length > len(mm):
            raise OrbaxFormatError(f"{what}: bytes [{offset}, {offset + length}) of "
                                   f"{rel_path}, which has {len(mm)}")
        return memoryview(mm)[offset:offset + length]

    def _keys(self, cur: _Cursor, n: int, interior: bool):
        prefix = [0] + cur.varints(n - 1)
        suffix = cur.varints(n)
        common = cur.varints(n) if interior else None
        keys, prev = [], b""
        for i in range(n):
            if prefix[i] > len(prev):
                cur.fail(f"key {i}: prefix {prefix[i]} longer than the previous key")
            prev = prev[:prefix[i]] + cur.take(suffix[i])
            keys.append(prev)
        return keys, common

    def _walk(self, ref, height: int, inherited: bytes) -> None:
        base, rel_path, offset, length = ref
        what = f"{os.path.join(self.root, rel_path)} [{offset}, +{length})"
        cur = _Cursor(_decode_file(self._slice(rel_path, offset, length, what), NODE_MAGIC,
                                   what, max(self.max_node_bytes, 1)), what)
        if cur.u8() != height:
            cur.fail(f"node height differs from its reference's {height}")
        files = self._file_table(cur, base)
        n = cur.varint()
        if n == 0:
            cur.fail("a node without entries")
        keys, common = self._keys(cur, n, interior=height > 0)
        if height > 0:
            ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(3 * n)  # statistics
            for key, c, i, o, ln in zip(keys, common, ids, offsets, lengths):
                if c > len(key):
                    cur.fail(f"subtree prefix {c} longer than its key")
                self._walk(self._ref(files, i, o, ln, what), height - 1, inherited + key[:c])
            return
        sizes = cur.varints(n)
        kinds = cur.varints(n)
        if any(k not in (0, 1) for k in kinds):
            cur.fail(f"value kinds {sorted(set(kinds))}: 0 (inline) and 1 (out of line) are read")
        m = sum(kinds)
        ids, offsets = cur.varints(m), cur.varints(m)
        j = 0
        for key, size, kind in zip(keys, sizes, kinds):
            name = (inherited + key).decode()
            if kind == 0:
                self.values[name] = cur.take(size)
            else:
                self.values[name] = self._ref(files, ids[j], offsets[j], size, what)[1:]
                j += 1
        if cur.at != len(cur.buf):
            cur.fail(f"{len(cur.buf) - cur.at} bytes after the last value")

    def get(self, key: str):
        """The value of `key`, or None when the store lacks it."""
        ref = self.values.get(key)
        if ref is None or isinstance(ref, bytes):
            return ref
        rel_path, offset, length = ref
        return self._slice(rel_path, offset, length, f"{self.root} key {key!r}")

    def close(self) -> None:
        for mm in self._maps.values():
            if isinstance(mm, mmap.mmap):
                mm.close()
        self._maps.clear()


# ---- zarr v2 ------------------------------------------------------------------------------------


def _fill(value, dtype: np.dtype):
    if value is None:
        return 0  # tensorstore fills a missing chunk of a null fill value with zeros
    return np.array(float(value) if isinstance(value, str) else value).astype(dtype)


def read_zarr(store: OcdbtStore, name: str) -> Tuple[np.ndarray, int]:
    """The zarr v2 array stored under `name/`; (the array, the compressed
    bytes read)."""
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise OrbaxFormatError(f"{store.root}: no zarr array {name!r} (no {name}/.zarray)")
    meta = json.loads(bytes(raw))
    where = f"{store.root} array {name!r}"
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{where}: zarr_format {meta.get('zarr_format')} (2 is read)")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise OrbaxFormatError(f"{where}: order {meta.get('order')} / filters "
                               f"{meta.get('filters')} (order C without filters is read)")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{where}: compressor {comp.get('id')!r} (zstd or none is read)")
    if not isinstance(meta.get("dtype"), str) or "bfloat16" in meta["dtype"]:
        raise OrbaxFormatError(f"{where}: dtype {meta.get('dtype')!r} is not read")
    dtype = np.dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c < 1 for c in chunks):
        raise OrbaxFormatError(f"{where}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    out = np.empty(shape, dtype)
    read = 0
    for idx in np.ndindex(*grid):
        key = f"{name}/" + (sep.join(str(i) for i in idx) if idx else "0")
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        data = store.get(key)
        if data is None:
            out[region] = _fill(meta.get("fill_value"), dtype)
            continue
        read += len(data)
        whole = tuple(chunks) == shape
        chunk = out if whole else np.empty(chunks, dtype)
        if comp is None:
            if len(data) != chunk.nbytes:
                raise OrbaxFormatError(f"{where} chunk {key!r}: {len(data)} bytes, expected "
                                       f"{chunk.nbytes}")
            chunk.reshape(-1).view(np.uint8)[:] = np.frombuffer(data, np.uint8)
        else:
            zstd.decompress_into(data, chunk.reshape(-1).view(np.uint8),
                                 what=f"{where} chunk {key!r}")
        if not whole:
            out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out, read


# ---- the tree -----------------------------------------------------------------------------------


def _param_names(item: str) -> Dict[str, tuple]:
    """{param_name: write_shape} of every process's `array_metadatas` file
    (orbax writes them for jax arrays; a tree of numpy arrays has none)."""
    folder = os.path.join(item, "array_metadatas")
    names = {}
    if not os.path.isdir(folder):
        return names
    for fname in sorted(os.listdir(folder)):
        with open(os.path.join(folder, fname)) as f:
            for entry in json.load(f)["array_metadatas"]:
                meta = entry["array_metadata"]
                names[meta["param_name"]] = tuple(meta["write_shape"])
    return names


def _assemble(node):
    """Nested {"kind", "items"} builders -> dicts and lists."""
    if not isinstance(node, dict) or "kind" not in node:
        return node
    items = {k: _assemble(v) for k, v in node["items"].items()}
    if node["kind"] == "dict":
        return items
    idx = sorted(items)
    if idx != list(range(len(idx))):
        raise OrbaxFormatError(f"sequence indices {idx} are not 0..{len(idx) - 1}")
    return [items[i] for i in idx]


class Restored(dict):
    """The restored tree (a dict), with `step`, `bytes_decoded` (the arrays'
    bytes), `bytes_read` (their compressed bytes) and `seconds`."""

    step: Optional[int] = None
    bytes_decoded = 0
    bytes_read = 0
    seconds = 0.0


def restore(path: str) -> Restored:
    """The tree `ocp.CheckpointManager(path).restore(step)` returns for the
    latest finished step of `path` (or the step directory `path`), numpy
    arrays in place of jax ones."""
    t0 = time.perf_counter()
    step_dir, step = step_directory(path)
    item = os.path.join(step_dir, ITEM)
    meta_path = os.path.join(item, "_METADATA")
    if not os.path.isfile(meta_path):
        raise OrbaxFormatError(f"{step_dir}: no {ITEM}/_METADATA (not a StandardSave item)")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{meta_path}: use_zarr3 is true; zarr v3 arrays are not read")
    if not meta.get("use_ocdbt"):
        raise OrbaxFormatError(f"{meta_path}: use_ocdbt is false; arrays outside an OCDBT "
                               "store are not read")
    names = _param_names(item)
    store = OcdbtStore(item)
    root = {"kind": "dict", "items": {}}
    out = Restored()
    for keystr, entry in meta["tree_metadata"].items():
        keys = entry["key_metadata"]
        value = entry["value_metadata"]
        node = root
        for depth, k in enumerate(keys):
            kind = {KEY_SEQUENCE: "list", KEY_DICT: "dict"}.get(k["key_type"])
            if kind is None:
                raise OrbaxFormatError(f"{meta_path}: {keystr}: key type {k['key_type']}")
            if node["kind"] != kind:
                if node["items"]:
                    raise OrbaxFormatError(f"{meta_path}: {keystr}: mixes sequence and dict keys")
                node["kind"] = kind
            key = int(k["key"]) if kind == "list" else k["key"]
            if depth == len(keys) - 1:
                break
            node = node["items"].setdefault(key, {"kind": "dict", "items": {}})
        vtype = value["value_type"]
        if vtype in EMPTY_VALUES:
            node["items"][key] = EMPTY_VALUES[vtype]()
            continue
        if vtype not in ARRAY_TYPES:
            raise OrbaxFormatError(f"{meta_path}: {keystr}: value type {vtype!r} is not read")
        name = ".".join(str(k["key"]) for k in keys)
        if vtype == "jax.Array" and name not in names:
            raise OrbaxFormatError(f"{item}: {keystr} ({name!r}) is in no array_metadatas file")
        arr, nread = read_zarr(store, name)
        declared = {tuple(value.get("write_shape", arr.shape)), names.get(name, arr.shape)}
        if declared != {arr.shape}:
            raise OrbaxFormatError(f"{item}: {keystr}: array {arr.shape}, metadata "
                                   f"{value.get('write_shape')} / {names.get(name)}")
        node["items"][key] = arr
        out.bytes_decoded += arr.nbytes
        out.bytes_read += nread
    store.close()
    out.update(_assemble(root))
    out.step = step
    out.seconds = time.perf_counter() - t0
    return out
