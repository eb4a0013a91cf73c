"""The JAX package's native host loader, pointed at the port's build of the
same library.

``frcnn_tpu/data/native.py`` runs ``make`` into ``csrc/libfrcnn_host.so``
in place, with no lock, and a failed load marks the process for good: from
then on every JAX ``BatchIterator`` in it quietly takes the Python path.
Test workers running the JAX package's native tests race on that file. The
port builds the same ``csrc/host_pipeline.cpp`` with the same flags and
libraries under a file lock and renames it into place
(``frcnn_tpu_torch/data/native.py``), so the port's tests load the reference
from that file, with the reference's load state reset.
"""

import pytest

from frcnn_tpu.data import native as j_native
from frcnn_tpu_torch.data import native as t_native


def point_reference_at_port_library(mp: pytest.MonkeyPatch) -> None:
    """Through ``mp``: the reference loads the port's library afresh (where
    the port's builds; otherwise it keeps its own file)."""
    if t_native.available():
        mp.setattr(j_native, "_LIB_PATH", t_native._lib_path())
    mp.setattr(j_native, "_lib", None)
    mp.setattr(j_native, "_tried", False)


@pytest.fixture
def reference_native(monkeypatch):
    point_reference_at_port_library(monkeypatch)


def need_native() -> None:
    """Skip where the port's library does not build; otherwise the
    reference must load it too, so that a native case never compares the
    port's native path with the reference's Python path."""
    if not t_native.available():
        pytest.skip(f"native host library not built: "
                    f"{t_native.build_error()}")
    assert j_native.available(), (
        f"the JAX package's native loader did not load {j_native._LIB_PATH}")
