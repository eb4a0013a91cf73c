"""The port's public API against the JAX package's, by name and by value.

By name: every module of ``frcnn_tpu/`` is parsed with ``ast`` (no JAX is
imported for it). Each public top-level function and class, each public
method of a public class and each ``__all__`` entry must be defined at the
same path in ``frcnn_tpu_torch/`` (an ``__all__`` entry in the port's
``__all__``), or be mapped in :data:`COUNTERPARTS` to a port name that
exists, with the reason. A new public name in the JAX package fails here
until the port has it or the table says where its counterpart is.

By value, on seeded numpy inputs (one torch thread): the box algebra
(atol 0 on integer-valued boxes, 1e-6 on others; degenerate, inverted and
fully outside boxes included), the localizer's ``layer_index`` at every
depth (exactly equal), the anchor lookup tables and ``get`` over every
anchor of the tiny config and the flatten round trip (exactly equal),
``resolve_nms_scores`` for each kind of ``scores``, unbatched and batched
``nms``, ``nms_indices_sorted`` and ``per_class_nms`` (indices and
validity exactly equal; ``per_class_nms`` on inputs whose same-class IoUs
stay at least 1e-5 from the threshold), and ``roi_pool_feature_rects``
(exactly equal). On CPU tensors the NMS entries run the plain keep mask
through ``nms_kernel.nms_keep_slots``, the kernel's wrapper, once a call.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frcnn_tpu.geometry import boxes as jB
from frcnn_tpu.geometry.anchors import AnchorGenerator as JGen
from frcnn_tpu.geometry import localizer as jL
from frcnn_tpu.ops.roi_pool import roi_pool_feature_rects as j_roi_rects
from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.geometry import boxes as tB
from frcnn_tpu_torch.geometry.anchors import AnchorGenerator as TGen
from frcnn_tpu_torch.geometry import localizer as tL
from frcnn_tpu_torch.ops import nms_kernel
from frcnn_tpu_torch.ops.roi_pool import roi_pool_feature_rects as t_roi_rects
from tests.tiny import tiny_config

# the modules: each package exports the function ``nms`` under their name
jnms = importlib.import_module("frcnn_tpu.ops.nms")
tnms = importlib.import_module("frcnn_tpu_torch.ops.nms")

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "frcnn_tpu"
PORT_PKG = ROOT / "frcnn_tpu_torch"

# "<module path>:<name>" in the JAX package -> ("<module path>:<name>" in
# the port, why that is the counterpart). Names are functions, classes,
# "Class.method" or, in an __init__.py, __all__ entries.
COUNTERPARTS = {
    "geometry/localizer.py:Localizer.input_to_feature_rect_jax": (
        "geometry/localizer.py:Localizer.input_to_feature_rect_t",
        "the port's tensor methods end in _t instead of _jax"),
    "geometry/localizer.py:Localizer.feature_map_size_jax": (
        "geometry/localizer.py:Localizer.feature_map_size_t",
        "the port's tensor methods end in _t instead of _jax"),
    "models/__init__.py:init_params": (
        "models/__init__.py:init_models",
        "the port initialises seeded modules, not a flax parameter tree"),
    "models/factory.py:init_params": (
        "models/factory.py:init_models",
        "the port initialises seeded modules, not a flax parameter tree"),
    "models/layers.py:msra_conv_init": (
        "models/factory.py:init_models",
        "torch modules are initialised in place there, MSRA fan-out "
        "normal for convs"),
    "models/layers.py:torch_linear_kernel_init": (
        "models/factory.py:init_models",
        "torch modules are initialised in place there, uniform "
        "+-1/sqrt(fan_in) for linear weights"),
    "models/layers.py:torch_linear_bias_init": (
        "models/factory.py:init_models",
        "torch modules are initialised in place there, uniform "
        "+-1/sqrt(fan_in) for linear biases"),
    "models/layers.py:PReLU": (
        "models/layers.py:prelu",
        "the networks hold torch.nn.PReLU (one slope, 0.25) and apply it "
        "through prelu"),
    "models/quant.py:quantize_pnet_params": (
        "models/quant.py:quantize_pnet",
        "quantizes the float32 modules instead of a parameter tree"),
    "models/quant.py:quant_pnet_apply": (
        "models/quant.py:QuantizedPNet.forward",
        "the int8 forward is the module's own forward"),
    "models/quant.py:QuantizedPNetAdapter": (
        "models/quant.py:QuantizedPNet",
        "an nn.Module called like ProposalNet needs no adapter"),
    "models/quant.py:QuantizedPNetAdapter.calibrate": (
        "models/quant.py:QuantizedPNet.calibrate",
        "the same calibration on the module"),
    "models/quant.py:QuantizedPNetAdapter.apply": (
        "models/quant.py:QuantizedPNet.forward",
        "flax's apply is torch's forward"),
    "ops/normalization.py:phase_masks": (
        "ops/normalization.py:_s2d_masks",
        "one function builds the luminance masks and the chroma factors"),
    "ops/normalization.py:chroma_masks": (
        "ops/normalization.py:_s2d_masks",
        "one function builds the luminance masks and the chroma factors"),
    "ops/pallas_block0.py:block0_weights": (
        "ops/block0_kernel.py:block0_weights",
        "the CUDA kernel's module holds its weight layout"),
    "ops/pallas_block0.py:block0_weights_jnp": (
        "ops/block0_kernel.py:block0_weights",
        "one tensor function serves the host and the device"),
    "ops/pallas_block0.py:pack_s2d": (
        "ops/block0_kernel.py:pack_s2d", "the CUDA kernel's module"),
    "ops/pallas_block0.py:pack_s2d_np": (
        "ops/block0_kernel.py:pack_s2d_np", "the CUDA kernel's module"),
    "ops/pallas_block0.py:views_from_s2d": (
        "ops/block0_kernel.py:fused_block0",
        "the CUDA kernel reads the two planes itself; no shifted views"),
    "ops/pallas_block0.py:fused_block0": (
        "ops/block0_kernel.py:fused_block0", "the CUDA kernel's wrapper"),
    "ops/pallas_block0.py:block0_nhwc": (
        "ops/block0_kernel.py:block0_nhwc", "the CUDA kernel's module"),
    "ops/pallas_block0_2conv.py:block0_2conv_weights": (
        "ops/block0_2conv_kernel.py:block0_2conv_weights",
        "the CUDA kernel's module holds its weight layout"),
    "ops/pallas_block0_2conv.py:block0_2conv_weights_jnp": (
        "ops/block0_2conv_kernel.py:block0_2conv_weights",
        "one tensor function serves the host and the device"),
    "ops/pallas_block0_2conv.py:block0_2conv_weights_q_jnp": (
        "ops/block0_2conv_kernel.py:block0_2conv_weights_q",
        "the int8 conv1 layout, a tensor function"),
    "ops/pallas_block0_2conv.py:fused_block0_2conv": (
        "ops/block0_2conv_kernel.py:fused_block0_2conv",
        "the CUDA kernel's wrapper"),
    "ops/pallas_block0_2conv.py:block0_2conv_nhwc": (
        "ops/block0_2conv_kernel.py:block0_2conv_nhwc",
        "the CUDA kernel's module"),
    "ops/pallas_block0_2conv.py:block0_2conv_nhwc_q": (
        "ops/block0_2conv_kernel.py:fused_block0_2conv",
        "the int8 conv1 mode is that wrapper's w1_scale and inv_y"),
    "ops/pallas_nms.py:pallas_nms_keep_mask": (
        "ops/nms_kernel.py:nms_keep_mask", "the CUDA kernel's wrapper"),
    "ops/pallas_nms.py:pallas_nms": (
        "ops/nms_kernel.py:cuda_nms", "sort, kernel and indices, batched"),
    "ops/pallas_pool_bwd.py:pool_bwd_supported": (
        "ops/pool_bwd_kernel.py:ceil_max_pool_2x2_bwd",
        "the CUDA kernel takes odd W too, so no shape falls back"),
    "ops/pallas_pool_bwd.py:ceil_max_pool_2x2_firstmax": (
        "ops/pool_bwd_kernel.py:ceil_max_pool_2x2_firstmax",
        "the CUDA kernel's module"),
    "ops/pallas_roi_pool.py:pallas_adaptive_max_pool": (
        "ops/roi_pool_kernel.py:adaptive_max_pool_valid_grad",
        "the port's wrapper always takes the validity mask"),
    "ops/pallas_roi_pool.py:pallas_adaptive_max_pool_valid": (
        "ops/roi_pool_kernel.py:adaptive_max_pool_valid_grad",
        "forward and backward kernels under one autograd function"),
    "parallel/__init__.py:make_mesh": (
        "parallel/__init__.py:rank_group",
        "a torch.distributed group of one device per rank is the mesh"),
    "parallel/__init__.py:batch_sharding": (
        "parallel/__init__.py:batch_shard",
        "each rank computes its rows and all-reduces over the group"),
    "parallel/__init__.py:replicated_sharding": (
        "parallel/__init__.py:local_device",
        "each rank holds a whole replica on its own device"),
    "parallel/__init__.py:shard_batch": (
        "parallel/__init__.py:batch_rows", "a rank's rows of a batch"),
    "parallel/mesh.py:make_mesh": (
        "parallel/mesh.py:rank_group",
        "a torch.distributed group of one device per rank is the mesh"),
    "parallel/mesh.py:batch_sharding": (
        "parallel/mesh.py:batch_shard",
        "each rank computes its rows and all-reduces over the group"),
    "parallel/mesh.py:replicated_sharding": (
        "parallel/mesh.py:local_device",
        "each rank holds a whole replica on its own device"),
    "parallel/mesh.py:shard_batch": (
        "parallel/mesh.py:batch_rows", "a rank's rows of a batch"),
    "parallel/mesh.py:chunk_sharding": (
        "parallel/mesh.py:batch_rows",
        "run_chunk steps batch by batch, each split by rows"),
    "parallel/mesh.py:shard_chunk": (
        "parallel/mesh.py:batch_rows",
        "run_chunk steps batch by batch, each split by rows"),
    "train/objective.py:label_one_image": (
        "train/objective.py:label_batch",
        "labels the whole batch at once, no per-image vmap"),
    "utils/compile_cache.py:enable_compile_cache": (
        "ops/cuda_lib.py:build",
        "the kernels are built once per source hash into _build/"),
}


def _modules(pkg: Path):
    return sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*.py")
                  if "_build" not in p.parts)


def _all_of(tree) -> list:
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return [e.value for e in node.value.elts]
    return []


def _public(rel: str) -> list:
    """The public names of a JAX module, in source order."""
    tree = ast.parse((JAX_PKG / rel).read_text())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and not node.name.startswith("_"):
            out.append(node.name)
            if isinstance(node, ast.ClassDef):
                out += [f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, ast.FunctionDef)
                        and not m.name.startswith("_")]
    return out + [n for n in _all_of(tree) if n not in out]


def _defines(rel: str, name: str) -> bool:
    """The port's module ``rel`` defines ``name`` (an ``__init__.py``:
    exports it in ``__all__``)."""
    path = PORT_PKG / rel
    if not path.exists():
        return False
    tree = ast.parse(path.read_text())
    if rel.endswith("__init__.py"):
        return name in _all_of(tree)
    cls, _, method = name.rpartition(".")
    for node in tree.body:
        if not cls and isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and node.name == name:
            return True
        if cls and isinstance(node, ast.ClassDef) and node.name == cls:
            return any(isinstance(m, ast.FunctionDef) and m.name == method
                       for m in node.body)
    return False


def _target_exists(target: str) -> bool:
    rel, name = target.split(":")
    return _defines(rel, name)


@pytest.mark.parametrize("rel", _modules(JAX_PKG))
def test_every_public_name_has_a_counterpart(rel):
    missing = []
    for name in _public(rel):
        key = f"{rel}:{name}"
        if _defines(rel, name):
            assert key not in COUNTERPARTS, f"{key}: defined at the same " \
                f"path, the COUNTERPARTS entry is stale"
            continue
        if key not in COUNTERPARTS:
            missing.append(name)
            continue
        target, reason = COUNTERPARTS[key]
        assert reason.strip(), key
        assert _target_exists(target), f"{key} -> {target}: not in the port"
    assert not missing, f"{rel}: no counterpart in the port for {missing}"


def test_counterparts_name_public_jax_names():
    public = {f"{rel}:{n}" for rel in _modules(JAX_PKG) for n in _public(rel)}
    assert set(COUNTERPARTS) <= public, sorted(set(COUNTERPARTS) - public)


SUBPACKAGES = ["", "data", "detect", "geometry", "models", "ops", "parallel",
               "train", "utils"]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_package_exports_resolve(sub):
    """Each name of a port package's ``__all__`` resolves, and the package
    exports each name of the JAX package's ``__all__`` or its mapped
    counterpart."""
    rel = f"{sub}/__init__.py" if sub else "__init__.py"
    mod = importlib.import_module(
        "frcnn_tpu_torch" + (f".{sub}" if sub else ""))
    for name in mod.__all__:
        assert getattr(mod, name) is not None, name
    for name in _all_of(ast.parse((JAX_PKG / rel).read_text())):
        target = COUNTERPARTS.get(f"{rel}:{name}", (f"{rel}:{name}",))[0]
        assert target.split(":")[1] in mod.__all__, (rel, name)


def test_top_level_import_is_light():
    """``import frcnn_tpu_torch`` imports nothing (not even torch); the
    nine lazy names then resolve without loading the kernel library."""
    code = (
        "import sys, frcnn_tpu_torch as p\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n"
        "assert [getattr(p, n).__name__ for n in p.__all__] == p.__all__\n"
        "from frcnn_tpu_torch import Detector, duplo_config\n"
        "from frcnn_tpu_torch.ops import cuda_lib\n"
        "assert cuda_lib._lib is None\n"
        "assert not any(k.launches for k in cuda_lib.REGISTRY.values())\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    jall = _all_of(ast.parse((JAX_PKG / "__init__.py").read_text()))
    import frcnn_tpu_torch

    assert frcnn_tpu_torch.__all__ == jall


# -- by value -----------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


CLIP = np.array([0.0, 0.0, 100.0, 80.0], np.float32)
# zero-size, zero-width, inverted, on the clip edges, fully outside it on
# every side
SPECIAL = np.array([[10, 10, 10, 10], [5, 7, 5, 30], [40, 30, 20, 10],
                    [0, 0, 100, 80], [150, 90, 170, 120],
                    [-50, -40, -10, -5], [-30, 20, -2, 60],
                    [110, -20, 130, 200]], np.float32)


def _box_inputs(integer: bool):
    """Two aligned box sets a, b (b partly inside a), per-box numbers and
    a per-box clip box."""
    rng = np.random.default_rng(5 if integer else 6)
    n = 40
    mins = rng.uniform(-30, 120, (n, 2))
    sizes = rng.uniform(0, 50, (n, 2))
    a = np.concatenate([mins, mins + sizes], 1)
    b = a + rng.uniform(-10, 10, (n, 4))
    b[: n // 2] = a[: n // 2] + np.array([1, 1, -1, -1]) * rng.uniform(
        0, 6, (n // 2, 1))
    nums = rng.uniform(-3, 3, (4, n + len(SPECIAL)))
    if integer:
        a, b, nums = np.round(a), np.round(b), np.round(nums)
    a = np.concatenate([a, SPECIAL]).astype(np.float32)
    b = np.concatenate([b, SPECIAL[::-1]]).astype(np.float32)
    clip = np.broadcast_to(CLIP, a.shape).copy()
    clip[::3] = [20.0, 10.0, 60.0, 50.0]
    return dict(a=a, b=b, n0=nums[0].astype(np.float32),
                n1=nums[1].astype(np.float32), clip=clip)


BOX_CALLS = {
    "center": lambda L, x: L.center(x["a"]),
    "from_center_wh": lambda L, x: L.from_center_wh(
        x["a"][..., 0], x["a"][..., 1], x["b"][..., 2], x["b"][..., 3]),
    "scale": lambda L, x: (L.scale(x["a"], 2), L.scale(x["a"], 0.5, 3),
                           L.scale(x["a"], x["n0"], x["n1"])),
    "offset": lambda L, x: (L.offset(x["a"], 3, -7),
                            L.offset(x["a"], x["n0"], x["n1"])),
    "inflate": lambda L, x: (L.inflate(x["a"], 2, 5),
                             L.inflate(x["a"], x["n0"], x["n1"])),
    "clip": lambda L, x: (L.clip(x["a"], x["clip"]),
                          L.clip(x["b"], x["clip"][0])),
    "hflip": lambda L, x: L.hflip(x["a"], 160),
    "vflip": lambda L, x: L.vflip(x["a"], 128),
    "snap_to_int": lambda L, x: L.snap_to_int(x["b"] * 0.75),
    "is_empty": lambda L, x: L.is_empty(x["a"]),
    "contains": lambda L, x: (L.contains(x["a"], x["b"]),
                              L.contains(x["b"], x["a"])),
    "inside": lambda L, x: (L.inside(x["a"], x["b"]),
                            L.inside(x["b"], x["a"])),
    "union": lambda L, x: L.union(x["a"], x["b"]),
    "intersect": lambda L, x: (L.intersect(x["a"], x["b"]),
                               L.intersect(x["a"], x["clip"])),
}


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("fn", sorted(BOX_CALLS))
def test_box_algebra_matches_jax(fn, integer):
    x = _box_inputs(integer)
    want = BOX_CALLS[fn](jB, {k: jnp.asarray(v) for k, v in x.items()})
    got = BOX_CALLS[fn](tB, {k: _t(v) for k, v in x.items()})
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    atol = 0.0 if integer else 1e-6
    for w, g in zip(want, got, strict=True):
        w = np.asarray(w)
        assert g.shape == w.shape and g.numpy().dtype == w.dtype, fn
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol)
    if fn == "clip":       # a fully outside box collapses to an empty one
        out = got[0].numpy()[-len(SPECIAL):][4:6]
        assert ((out[:, 0] == out[:, 2]) | (out[:, 1] == out[:, 3])).all()


def _localizers():
    cfg = tiny_config()
    tcfg = Config.from_json(cfg.to_json())
    pairs = [(f"tap{i}", jL.layer_infos_for_tap(cfg.model, i),
              tL.layer_infos_for_tap(tcfg.model, i))
             for i in range(len(cfg.scales))]
    return pairs + [("fm", jL.layer_infos_for_feature_map(cfg.model),
                     tL.layer_infos_for_feature_map(tcfg.model))]


@pytest.mark.parametrize("which", [p[0] for p in _localizers()])
def test_localizer_layer_index_at_every_depth(which):
    _, jl, tl = next(p for p in _localizers() if p[0] == which)
    jloc, tloc = jL.Localizer(jl), tL.Localizer(tl)
    rng = np.random.default_rng(3)
    rects = np.concatenate([rng.uniform(-20, 150, (12, 2)),
                            rng.uniform(150, 300, (12, 2))], 1).tolist()
    rects += [[0, 0, 1, 1], [7, 9, 7, 9], [2.5, 3.25, 40.75, 18.5]]
    for depth in [None, *range(len(jl) + 1)]:
        for r in rects:
            for m in ("feature_to_input_rect", "input_to_feature_rect"):
                want = getattr(jloc, m)(*r, layer_index=depth)
                got = getattr(tloc, m)(*r, layer_index=depth)
                assert got == want, (m, depth, r)
    for r in rects:        # the default walks every layer
        for m in ("feature_to_input_rect", "input_to_feature_rect"):
            assert getattr(tloc, m)(*r) == getattr(tloc, m)(
                *r, layer_index=len(tl))


@pytest.fixture(scope="module")
def gens():
    cfg = tiny_config()
    return JGen(cfg), TGen(Config.from_json(cfg.to_json()))


def test_lookup_tables_and_get_over_every_anchor(gens):
    jg, tg = gens
    for want, got in zip(jg.lookup_tables(extent=60),
                         tg.lookup_tables(extent=60), strict=True):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
    for k in range(tg.num_anchors):
        args = (int(tg.tap[k]), int(tg.aspect[k]), int(tg.fy[k]),
                int(tg.fx[k]))
        got = tg.get(*args)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, jg.get(*args))
        np.testing.assert_array_equal(got.astype(np.float32), tg.boxes[k])


def test_flatten_and_unflatten_round_trip(gens):
    jg, tg = gens
    rng = np.random.default_rng(2)
    maps = [rng.normal(size=(h, w, 18)).astype(np.float32)
            for (h, w) in tg.tap_dims]
    flat = tg.flatten_tap_outputs([_t(m) for m in maps])
    assert flat.shape == (tg.num_anchors, 6) and flat.device.type == "cpu"
    np.testing.assert_array_equal(
        flat.numpy(),
        np.asarray(jg.flatten_tap_outputs([jnp.asarray(m) for m in maps])))
    back = tg.unflatten_to_tap_deltas(flat)
    jback = jg.unflatten_to_tap_deltas(jnp.asarray(flat.numpy()))
    for m, b, jb in zip(maps, back, jback, strict=True):
        np.testing.assert_array_equal(b.numpy(), m)
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def _cluttered(rng, n, lo=0, hi=300, size=(10, 80)):
    """Integer-valued boxes in clusters (many overlaps), float32."""
    centers = rng.uniform(lo + 40, hi - 40, (max(n // 6, 1), 2))
    c = centers[rng.integers(0, len(centers), n)] + rng.normal(0, 12, (n, 2))
    wh = rng.uniform(*size, (n, 2))
    return np.round(np.concatenate([c - wh / 2, c + wh / 2], 1)).astype(
        np.float32)


@pytest.mark.parametrize("scores", [None, "area", 1, "tensor"])
def test_resolve_nms_scores_each_kind(scores):
    boxes = _cluttered(np.random.default_rng(1), 20)
    s = np.random.default_rng(2).uniform(0, 1, 20).astype(np.float32)
    arg_j = jnp.asarray(s) if scores == "tensor" else scores
    arg_t = _t(s) if scores == "tensor" else scores
    want = np.asarray(jnms.resolve_nms_scores(jnp.asarray(boxes), arg_j))
    got = tnms.resolve_nms_scores(_t(boxes), arg_t)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tnms.resolve_nms_scores(_t(boxes), "volume")


def _nms_case(seed: int, n: int = 48):
    rng = np.random.default_rng(seed)
    boxes = _cluttered(rng, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[5:9] = scores[4]                       # ties
    boxes[10] = boxes[11]                         # duplicates
    valid = rng.uniform(size=n) > 0.1
    return boxes, scores, valid


def _j_nms(boxes, scores, valid, thr, max_out):
    """The JAX ``nms``; ``scores`` an array or one of its other kinds."""
    f = jax.jit(lambda b, v: jnms.nms(b, scores, v, thr, max_out))
    return tuple(np.asarray(o) for o in f(jnp.asarray(boxes),
                                          jnp.asarray(valid)))


class _Launches:
    """Counts calls of ``nms_kernel.nms_keep_slots``, the kernel's
    wrapper, which runs the plain keep mask on CPU tensors."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = nms_kernel.nms_keep_slots

        def counted(*a):
            self.n += 1
            return real(*a)

        monkeypatch.setattr(nms_kernel, "nms_keep_slots", counted)


@pytest.mark.parametrize("thr,max_out", [(0.3, 48), (0.1, 7), (0.5, 20)])
def test_nms_unbatched_and_batched(thr, max_out, monkeypatch):
    calls = _Launches(monkeypatch)
    cases = [_nms_case(s) for s in (1, 2, 3)]
    wants = [_j_nms(b, jnp.asarray(s), v, thr, max_out) for b, s, v in cases]
    for (b, s, v), (wi, wv) in zip(cases, wants):
        gi, gv = tnms.nms(_t(b), _t(s), _t(v), thr, max_out)
        assert gi.shape == (max_out,) and gi.dtype == torch.int32
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gv.numpy(), wv)
    bi, bv = tnms.nms(*(_t(np.stack(x)) for x in zip(*cases)), thr, max_out)
    np.testing.assert_array_equal(bi.numpy(), np.stack([w[0] for w in wants]))
    np.testing.assert_array_equal(bv.numpy(), np.stack([w[1] for w in wants]))
    assert calls.n == len(cases) + 1       # one per call, batched or not


@pytest.mark.parametrize("scores", [None, "area", 2])
def test_nms_score_variants(scores):
    boxes, _, valid = _nms_case(4)
    wi, wv = _j_nms(boxes, scores, valid, 0.3, 48)
    gi, gv = tnms.nms(_t(boxes), scores, _t(valid), 0.3, 48)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_array_equal(gv.numpy(), wv)


def test_nms_indices_sorted(monkeypatch):
    calls = _Launches(monkeypatch)
    cases = []
    for seed in (5, 6):
        boxes, scores, valid = _nms_case(seed)
        order = np.argsort(-np.where(valid, scores, -np.inf), kind="stable")
        cases.append((boxes[order], valid[order]))
    f = jax.jit(lambda b, v: jnms.nms_indices_sorted(b, v, 0.25, 32))
    wants = [tuple(np.asarray(o) for o in f(jnp.asarray(b), jnp.asarray(v)))
             for b, v in cases]
    for (b, v), (ws, wv) in zip(cases, wants):
        gs, gv = tnms.nms_indices_sorted(_t(b), _t(v), 0.25, 32)
        np.testing.assert_array_equal(gs.numpy(), ws)
        np.testing.assert_array_equal(gv.numpy(), wv)
    gs, gv = tnms.nms_indices_sorted(_t(np.stack([c[0] for c in cases])),
                                     _t(np.stack([c[1] for c in cases])),
                                     0.25, 32)
    np.testing.assert_array_equal(gs.numpy(), np.stack([w[0] for w in wants]))
    np.testing.assert_array_equal(gv.numpy(), np.stack([w[1] for w in wants]))
    assert calls.n == len(cases) + 1


def _iou_margin(boxes, classes, valid, thr) -> float:
    """Least |IoU (+1 pixel) - thr| over valid same-class pairs, float64."""
    b = boxes.astype(np.float64)
    iw = np.clip(np.minimum(b[:, None, 2], b[None, :, 2])
                 - np.maximum(b[:, None, 0], b[None, :, 0]) + 1, 0, None)
    ih = np.clip(np.minimum(b[:, None, 3], b[None, :, 3])
                 - np.maximum(b[:, None, 1], b[None, :, 1]) + 1, 0, None)
    area = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    inter = iw * ih
    iou = inter / (area[:, None] + area[None, :] - inter)
    pair = (classes[:, None] == classes[None, :]) & valid[:, None] \
        & valid[None, :] & ~np.eye(len(b), dtype=bool)
    return float(np.abs(iou - thr)[pair].min())


@pytest.mark.parametrize("thr", [0.1, 0.3])
def test_per_class_nms(thr, monkeypatch):
    calls = _Launches(monkeypatch)
    rng = np.random.default_rng(11)
    n, nc, bsz = 64, 4, 3
    boxes = (_cluttered(rng, bsz * n) + rng.uniform(0, 1, (bsz * n, 4))
             .astype(np.float32)).reshape(bsz, n, 4)
    scores = rng.uniform(0, 1, (bsz, n)).astype(np.float32)
    classes = rng.integers(0, nc, (bsz, n)).astype(np.int32)
    valid = rng.uniform(size=(bsz, n)) > 0.1
    for i in range(bsz):
        assert _iou_margin(boxes[i], classes[i], valid[i], thr) >= 1e-5
    f = jax.jit(lambda b, s, c, v: jnms.per_class_nms(b, s, c, v, nc, thr,
                                                       24))
    for i in range(bsz):
        wi, wv = (np.asarray(o) for o in f(*(jnp.asarray(x[i]) for x in (
            boxes, scores, classes, valid))))
        gi, gv = tnms.per_class_nms(_t(boxes[i]), _t(scores[i]),
                                    _t(classes[i]), _t(valid[i]), nc, thr, 24)
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gv.numpy(), wv)
    # batched: one offset span over the batch, as the JAX function's on
    # [B, N] inputs; its picks per image are those of a joint NMS per image
    gi, gv = tnms.per_class_nms(_t(boxes), _t(scores), _t(classes),
                                _t(valid), nc, thr, 24)
    shifted = np.asarray(jnms.class_offset_boxes(
        jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid)))
    for i in range(bsz):
        wi, wv = _j_nms(shifted[i], jnp.asarray(scores[i]), valid[i], thr, 24)
        np.testing.assert_array_equal(gi[i].numpy(), wi)
        np.testing.assert_array_equal(gv[i].numpy(), wv)
    assert calls.n == bsz + 1


def test_plain_nms_does_not_route_through_the_wrapper(monkeypatch):
    """The detector's reference path stays the plain keep mask."""
    calls = _Launches(monkeypatch)
    b, s, v = _nms_case(7)
    wi, wv = tnms.nms(_t(b), _t(s), _t(v), 0.25, 16)
    gi, gv = tnms.plain_nms(_t(b)[None], _t(s)[None], _t(v)[None], 0.25, 16)
    assert calls.n == 1
    np.testing.assert_array_equal(gi[0].numpy(), wi.numpy())
    np.testing.assert_array_equal(gv[0].numpy(), wv.numpy())


@pytest.mark.parametrize("which", ["tap0", "tap3", "fm"])
def test_roi_pool_feature_rects(which):
    _, jl, tl = next(p for p in _localizers() if p[0] == which)
    jloc, tloc = jL.Localizer(jl), tL.Localizer(tl)
    rng = np.random.default_rng(9)
    rects = _cluttered(rng, 40, lo=-40, hi=200, size=(1, 90))
    rects[:4] = [[0, 0, 1, 1], [60, 60, 60, 60], [-30, -30, -5, -5],
                 [150, 120, 400, 300]]
    rects = np.concatenate([rects, rects * 0.5 + 0.25]).astype(np.float32)
    fw, fh = tloc.feature_map_size(160, 128)
    want = np.asarray(j_roi_rects(jloc, jnp.asarray(rects), fw, fh))
    got = t_roi_rects(tloc, _t(rects), fw, fh)
    np.testing.assert_array_equal(got.numpy(), want)
    # per-image true sizes, as the detector passes them
    sizes = _t(np.array([[fw], [max(fw - 3, 1)]], np.float32))
    hs = _t(np.array([[fh], [max(fh - 2, 1)]], np.float32))
    r2 = np.stack([rects, rects[::-1]])
    want2 = np.asarray(j_roi_rects(jloc, jnp.asarray(r2),
                                   jnp.asarray(sizes.numpy()),
                                   jnp.asarray(hs.numpy())))
    np.testing.assert_array_equal(
        t_roi_rects(tloc, _t(r2), sizes, hs).numpy(), want2)
