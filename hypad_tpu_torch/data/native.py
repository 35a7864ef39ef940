"""ctypes bindings of the native C++ host engine: a port of
``hypad_tpu.data.native``.

The engine is the port's own copy of the JAX package's C++ sources,
``csrc/host/pipeline.cpp`` (the univariate preprocessing pass) and
``csrc/host/thresholds.cpp`` (the dynamic-threshold Nelder-Mead), built by
``_build.build_host`` with ``g++`` into ``_build/`` at first use. Both
entries give the bits of the numpy paths they stand for
(``data/pipeline.py``, ``detect/intervals.py`` ``_find_thresholds_batch``);
where the engine cannot build (no ``g++``) :func:`get_lib` returns None and
the callers run numpy, as JAX's do. :data:`runs` counts each entry's calls
that the engine answered, so a caller can tell which engine ran.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from hypad_tpu_torch import _build

_lock = threading.Lock()
_lib = None
_tried = False
build_error = None   # why the engine did not build, if it did not

# calls answered by the engine, per entry
runs = {"prepare_univariate": 0, "find_thresholds": 0}


class _HypadResult(ctypes.Structure):
    _fields_ = [
        ("index", ctypes.POINTER(ctypes.c_double)),
        ("n_buckets", ctypes.c_int64),
        ("windows", ctypes.POINTER(ctypes.c_float)),
        ("targets", ctypes.POINTER(ctypes.c_float)),
        ("x_index", ctypes.POINTER(ctypes.c_double)),
        ("y_index", ctypes.POINTER(ctypes.c_double)),
        ("n_windows", ctypes.c_int64),
        ("window_size", ctypes.c_int64),
        ("target_size", ctypes.c_int64),
    ]


def get_lib():
    """The loaded engine (built first if needed), or None when it cannot
    build; the reason is then in :data:`build_error`."""
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build.build_host()))
        except (OSError, RuntimeError) as exc:
            build_error = str(exc)
            return None
        dp = ctypes.POINTER(ctypes.c_double)
        lib.hypad_prepare_univariate.restype = ctypes.POINTER(_HypadResult)
        lib.hypad_prepare_univariate.argtypes = [
            dp, dp, ctypes.c_int64, ctypes.c_double, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64]
        lib.hypad_release.argtypes = [ctypes.POINTER(_HypadResult)]
        lib.hypad_release.restype = None
        lib.hypad_find_thresholds.restype = None
        lib.hypad_find_thresholds.argtypes = [
            dp, dp, dp, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, dp]
        _lib = lib
        return _lib


def available():
    return get_lib() is not None


def prepare_univariate(timestamps, values, interval, window_size=100,
                       target_size=1, step_size=1):
    """The native pipeline pass: (windows f32 (M, W), targets f32 (M, T),
    x_index, y_index, index), or None when the engine is unavailable or
    the signal too short."""
    lib = get_lib()
    if lib is None:
        return None
    ts = np.ascontiguousarray(timestamps, dtype=np.float64)
    vs = np.ascontiguousarray(values, dtype=np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    res = lib.hypad_prepare_univariate(
        ts.ctypes.data_as(dp), vs.ctypes.data_as(dp), len(ts),
        float(interval), window_size, target_size, step_size)
    if not res:
        return None
    try:
        r = res.contents
        M, W, T = r.n_windows, r.window_size, r.target_size
        out = (np.ctypeslib.as_array(r.windows, shape=(M, W)).copy(),
               np.ctypeslib.as_array(r.targets, shape=(M, T)).copy(),
               np.ctypeslib.as_array(r.x_index, shape=(M,)).copy(),
               np.ctypeslib.as_array(r.y_index, shape=(M,)).copy(),
               np.ctypeslib.as_array(r.index, shape=(r.n_buckets,)).copy())
    finally:
        lib.hypad_release(res)
    runs["prepare_univariate"] += 1
    return out


def find_thresholds(windows, means, stds, min_z=0, max_z=10):
    """The native dynamic thresholds (Wn,) of a (Wn, L) stack of threshold
    windows: the reference ``find_threshold`` (fmin from every integer z
    start, the last finite cost's z). ``means`` / ``stds`` are the windows'
    numpy statistics (numpy's pairwise sums are not replicated natively).
    None when the engine is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    W = np.ascontiguousarray(windows, dtype=np.float64)
    m = np.ascontiguousarray(means, dtype=np.float64)
    s = np.ascontiguousarray(stds, dtype=np.float64)
    out = np.empty(W.shape[0], np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.hypad_find_thresholds(
        W.ctypes.data_as(dp), m.ctypes.data_as(dp), s.ctypes.data_as(dp),
        W.shape[0], W.shape[1], int(min_z), int(max_z),
        out.ctypes.data_as(dp))
    runs["find_thresholds"] += 1
    return out
