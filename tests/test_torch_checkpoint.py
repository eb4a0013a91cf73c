"""The port's msgpack reader against flax's, on a checkpoint written by the
JAX package (exact: same tree, same leaves bit for bit)."""

import jax
import numpy as np
from flax import serialization as fser

from frcnn_tpu.models.factory import init_params
from frcnn_tpu.utils.serialization import save_checkpoint
from frcnn_tpu_torch.utils import serialization as tser
from tests.tiny import tiny_config


def _assert_same(a, b, path="root"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_checkpoint_reader_matches_flax(tmp_path):
    cfg = tiny_config()
    params, stats = init_params(cfg, jax.random.PRNGKey(0))
    path = str(tmp_path / "tiny.ckpt")
    save_checkpoint(path, params=params, batch_stats=stats,
                    opt_state=[np.arange(5, dtype=np.int32),
                               np.float32(2.5) * np.ones((2, 3), np.float32)],
                    step=1234567, stats={"loss": [1.5, -2.0, 3e40],
                                         "n": -70000, "ok": True,
                                         "none": None},
                    options={"name": "tiny-ü", "lr": 1e-4},
                    config_json=cfg.to_json())
    with open(path, "rb") as f:
        blob = f.read()
    ref = fser.msgpack_restore(blob)
    got = tser.load_checkpoint(path)
    _assert_same(ref, got)
    # every leaf of the tiny params tree, against the arrays saved
    for (kp, leaf) in jax.tree_util.tree_flatten_with_path(params)[0]:
        node = got["params"]
        for k in kp:
            node = node[k.key]
        assert np.array_equal(node, np.asarray(leaf)), kp


def test_reader_scalars_and_bfloat16():
    import jax.numpy as jnp

    tree = {"bf": np.asarray(jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16)),
            "i8": np.arange(-3, 3, dtype=np.int8),
            "big": list(range(20)), "s": "x" * 40, "neg": -33,
            "u64": 2 ** 63 + 5, "f": 0.1, "scalar": np.float32(4.5),
            "m": {str(i): i for i in range(20)}}
    got = tser.unpackb(fser.msgpack_serialize(tree))
    assert got["bf"].dtype == np.float32
    np.testing.assert_array_equal(got["bf"], [1.5, -2.25, 3.0])
    np.testing.assert_array_equal(got["i8"], tree["i8"])
    assert got["big"] == tree["big"] and got["s"] == tree["s"]
    assert got["neg"] == -33 and got["u64"] == 2 ** 63 + 5
    assert got["f"] == 0.1 and got["scalar"] == np.float32(4.5)
    assert got["m"] == tree["m"]
