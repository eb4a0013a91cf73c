"""The port's config reads and writes the JAX package's JSON schema, both
ways (exact equality of the loaded dataclasses' fields)."""

import dataclasses

import pytest

import frcnn_tpu.config as jcfg
import frcnn_tpu_torch.config as tcfg


def _pairs():
    return [
        ("duplo", jcfg.duplo_config(), tcfg.duplo_config()),
        ("imagenet", jcfg.imagenet_config(), tcfg.imagenet_config()),
        ("serving", jcfg.serving_config(), tcfg.serving_config()),
    ]


@pytest.mark.parametrize("name", ["duplo", "imagenet", "serving"])
def test_config_json_both_directions(name):
    _, j, t = next(p for p in _pairs() if p[0] == name)
    assert j.to_json() == t.to_json()
    from_j = tcfg.Config.from_json(j.to_json())
    from_t = jcfg.Config.from_json(t.to_json())
    assert dataclasses.asdict(from_j) == dataclasses.asdict(j)
    assert dataclasses.asdict(from_t) == dataclasses.asdict(t)
    assert from_j == t
    assert from_t == j


def test_serving_config_gating_matches():
    base = jcfg.duplo_config().replace(shapes=dataclasses.replace(
        jcfg.duplo_config().shapes, image_hw=(450, 800),
        portrait_hw=(801, 450)))
    tbase = tcfg.Config.from_json(base.to_json())
    assert tcfg.serving_config(tbase).to_json() == \
        jcfg.serving_config(base).to_json()
