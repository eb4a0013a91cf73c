"""The port's ``int8_static`` serving mode against the JAX package's on the
trained photo checkpoint (``tests/trained_photo.py::mode_case``): the
mode's config from ``tools/eval_quant_parity.py::mode_table`` and its
JAX counterpart, the published gates, two B=2 batches of photo scenes.
The unmarked cases run at a 224x400 bucket of the same config and
weights (a quarter of the checkpoint's 450x800: the JAX package's int8
chain takes minutes per call on the CPU at full size), the ``slow`` case
at 450x800.

int8_static (the nhwc chain at static scales, pools in bf16). The static
scales are held layer by layer (``trained_photo.check_scales``: rtol
1e-6, or one bf16 step of a layer's abs-max); measured: all equal.
Measured at 224x400: 8 of 9 detections matched (share 0.889). The miss:
a JAX detection (image 1, class 3, confidence 0.536, fg 0.9986) whose
proposal the port pools about 1 px away ([269.1, 10.0, 326.8, 131.4]
against [268.7, 9.7, 326.3, 130.3]) and classes background (0.44) over
class 3 (0.32): a class flip. The JAX package's own program run eagerly
(``jax.disable_jit()``) pools the port's box to the pixel and returns no
detection there either: XLA's rewrites under ``jit`` (a multiply by
``1/s`` for a division, fused multiply-adds) move int8 steps of the
chain, which the port, following the eager JAX functions, does not copy
(``ROADMAP.md``, the int8 chain). The test holds the share at 0.8 or
more, and that of the stage-1 proposals (IoU >= 0.5). At 450x800
(``slow``): 10 of 10 matched, 66 of 66 proposals, every scale equal.
"""

import pytest

from tests import trained_photo as TP

MODE = "int8_static"


@pytest.fixture(scope="module")
def case():
    return TP.mode_case(MODE, TP.SMALL_HW)


def test_calibrated_scales_match_jax(case):
    TP.check_scales(case[0], case[1])


def test_detections_match_jax(case):
    TP.check_detections(*case, share=0.8, proposals=0.8)


@pytest.mark.slow
def test_detections_match_jax_at_the_checkpoint_bucket():
    jd, det, batches = TP.mode_case(MODE, TP.HW)
    TP.check_scales(jd, det)
    TP.check_detections(jd, det, batches, share=0.8, proposals=0.8)
