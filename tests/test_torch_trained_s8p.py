"""The port's ``int8_static_s2d_s8p`` serving mode against the JAX
package's on the trained photo checkpoint
(``tests/trained_photo.py::mode_case``): the mode's config from
``tools/eval_quant_parity.py::mode_table`` and its JAX counterpart, the
published gates, two B=2 batches of photo scenes. The unmarked cases run
at a 224x400 bucket of the same config and weights (a quarter of the
checkpoint's 450x800: the JAX package's int8 chain takes minutes per
call on the CPU at full size), the ``slow`` case at 450x800.

int8_static_s2d_s8p, the checkpoint's own serving chain (block0's int8
output, the s8-pooled chain). The static scales are held layer by layer
(``trained_photo.check_scales``); measured: all equal. Measured at
224x400: 8 of 9 detections matched (share 0.889). The miss: a port
detection (image 1, class 3, confidence 0.449, fg 0.9985; class 5 next
at 0.328) on a proposal both packages pool, where the JAX program has
none: a class flip. The JAX package's own program run eagerly returns it
(class 3 at 0.447): the difference is XLA's rewrites under ``jit``, as
in ``test_torch_trained_static.py``. The test holds the share at 0.8 or
more, and that of the stage-1 proposals (IoU >= 0.5). At 450x800
(``slow``): 12 of 14 matched (0.857), 64 of 65 proposals, every scale
equal; the misses a class flip on one box (JAX class 4 at 0.485, the
port class 1 at 0.465).
"""

import pytest

from tests import trained_photo as TP

MODE = "int8_static_s2d_s8p"


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
