"""Torch-free reader for PyTorch checkpoint files.

The reference trains its NN emission surrogate with torch and persists it
via ``torch.save(model.state_dict(), '<prefix>_<dust>.nn')``
(ASOC_aux_NN.py:159) -- a zip archive holding a pickle
(``data.pkl``) whose tensors are persistent-id references into raw little-
endian storage blobs (``data/<key>``).  This framework has no torch
dependency, so the state dict is recovered here with a restricted
unpickler: only the handful of globals a tensor-only state dict can
legitimately contain are resolved, everything else is refused.

Returns plain numpy arrays; tensor strides are honoured (``as_strided``
view over the storage, then copied), so transposed / sliced saved tensors
round-trip exactly.
"""

import io
import pickle
import zipfile
from collections import OrderedDict

import numpy as np

_DTYPES = {
    "FloatStorage": np.float32,
    "DoubleStorage": np.float64,
    "HalfStorage": np.float16,
    "BFloat16Storage": None,          # no numpy dtype; rejected below
    "LongStorage": np.int64,
    "IntStorage": np.int32,
    "ShortStorage": np.int16,
    "CharStorage": np.int8,
    "ByteStorage": np.uint8,
    "BoolStorage": np.bool_,
}


class _StorageTag:
    """Stands in for torch.FloatStorage & co. inside the pickle."""

    def __init__(self, name):
        self.name = name


def _rebuild_tensor_v2(storage, offset, size, stride, requires_grad=False,
                       backward_hooks=None, metadata=None):
    # storage is the flat numpy array produced by persistent_load
    if not size:
        return storage[offset].copy()
    itemsize = storage.dtype.itemsize
    view = np.lib.stride_tricks.as_strided(
        storage[offset:], shape=tuple(size),
        strides=tuple(s * itemsize for s in stride))
    return view.copy()


def _rebuild_parameter(data, requires_grad=False, backward_hooks=None):
    return data


class _Unpickler(pickle.Unpickler):
    _ALLOWED = {
        ("collections", "OrderedDict"): OrderedDict,
        ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor_v2,
        ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
    }

    def __init__(self, fp, read_record):
        super().__init__(fp)
        self._read_record = read_record

    def find_class(self, module, name):
        fn = self._ALLOWED.get((module, name))
        if fn is not None:
            return fn
        if module == "torch" and name in _DTYPES:
            return _StorageTag(name)
        raise pickle.UnpicklingError(
            "refusing to unpickle %s.%s (not part of a plain torch "
            "state dict)" % (module, name))

    def persistent_load(self, pid):
        if not (isinstance(pid, tuple) and pid and pid[0] == "storage"):
            raise pickle.UnpicklingError("unknown persistent id %r" % (pid,))
        tag, key, _location, numel = pid[1], pid[2], pid[3], pid[4]
        dtype = _DTYPES.get(getattr(tag, "name", None))
        if dtype is None:
            raise pickle.UnpicklingError(
                "unsupported tensor storage type %r" % (tag,))
        raw = self._read_record(str(key))
        return np.frombuffer(raw, dtype="<" + np.dtype(dtype).str[1:],
                             count=int(numel)).copy()


def load_state_dict(path):
    """Load a ``torch.save``d state dict (zip format) as name -> ndarray.

    Only the modern zip serialization (torch >= 1.6 default) is accepted;
    the reference writes exactly that (ASOC_aux_NN.py:159).
    """
    if not zipfile.is_zipfile(path):
        raise ValueError(
            "%s is not a torch zip checkpoint (legacy torch serialization "
            "is not supported)" % path)
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        pkl = [n for n in names if n.endswith("/data.pkl") or n == "data.pkl"]
        if not pkl:
            raise ValueError("%s: no data.pkl in archive" % path)
        root = pkl[0][: -len("data.pkl")]
        byteorder = root + "byteorder"
        if byteorder in names and \
                zf.read(byteorder).decode().strip() != "little":
            raise ValueError("%s: big-endian checkpoint unsupported" % path)

        def read_record(key):
            return zf.read(root + "data/" + key)

        obj = _Unpickler(io.BytesIO(zf.read(pkl[0])), read_record).load()
    if not isinstance(obj, (dict, OrderedDict)):
        raise ValueError("%s: checkpoint is not a state dict" % path)
    return {str(k): np.asarray(v) for k, v in obj.items()}
