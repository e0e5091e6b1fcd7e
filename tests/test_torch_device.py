"""The one put of a host batch onto a device (``utils/device.to_device``)
and the device rule (``resolve_device``), on the CPU.

Every case gives the values and dtypes that ``torch.from_numpy(np.asarray(v))``
gives, and copies on the host only an array torch cannot take as it is.
"""

import warnings

import numpy as np
import pytest
import torch

from recalgorithm_tpu_torch.utils.device import resolve_device, to_device

_BASE = np.arange(24, dtype=np.int32).reshape(4, 6)


def _read_only():
    a = _BASE.copy()
    a.setflags(write=False)
    return a


# name -> (column, whether the put may read the array's own memory)
CASES = {
    "contiguous": (lambda: _BASE.copy(), True),
    "strided": (lambda: _BASE.copy()[:, ::2], True),
    "read_only": (_read_only, False),
    "reversed": (lambda: _BASE.copy()[::-1], False),
    "list": (lambda: [[1, 2], [3, 4]], False),
    "int32": (lambda: np.array([1, 2, 3], np.int32), True),
    "int64": (lambda: np.array([1, 2, 3], np.int64), True),
    "float32": (lambda: np.array([0.5, 1.5], np.float32), True),
}


def _want(v) -> torch.Tensor:
    """What ``torch.from_numpy(np.asarray(v))`` gives (from a copy where it
    refuses the array, as ``np.array`` made it for the ``Predictor``)."""
    return torch.from_numpy(np.array(v))


@pytest.mark.parametrize("mode", ["all", "columns", "out"])
@pytest.mark.parametrize("case", CASES)
def test_put_gives_the_values_and_dtypes_of_from_numpy(case, mode):
    make, shares = CASES[case]
    v = make()
    want = _want(v)
    if case != "reversed":  # torch refuses a negative stride
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # torch's own warning on a read-only array
            assert torch.equal(torch.from_numpy(np.asarray(v)), want)
    batch = {"x": v, "_index": np.arange(3)}
    if mode == "all":
        got = to_device(batch, "cpu")
        assert got.keys() == {"x", "_index"}
    elif mode == "columns":
        got = to_device(batch, "cpu", columns=frozenset({"x", "labels"}))
        assert got.keys() == {"x"}
    else:
        out = {"x": torch.full(want.shape, -1, dtype=want.dtype)}
        got = to_device(batch, "cpu", out=out)
        assert got is out and got["x"].data_ptr() == out["x"].data_ptr()
    x = got["x"]
    assert x.dtype == want.dtype and x.device.type == "cpu"
    assert torch.equal(x, want)
    if mode != "out":
        a = np.asarray(v)
        assert (x.data_ptr() == a.ctypes.data) is shares  # no host copy unless it must
        if case == "read_only":
            assert not a.flags.writeable  # the caller's array is left as it was


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)
