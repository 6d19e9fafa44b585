"""Reader for the stored MATLAB CVO batch-run result files.

The reference vendors a MATLAB run of the batch registration experiment
(data/rgbd_dataset/freiburg1_desk/freiburg1_desk_07-May-2019-02-35-00.mat,
written by rgbddataset_rkhs.m:87-88).  Its `result` cell array holds
`affine3d` objects, MATLAB MCOS class instances that scipy.io.loadmat
surfaces only as opaque handles; their 4x4 matrices live in the file's
`__function_workspace__` blob (the serialized MCOS property store).

`read_stored_run` scans that blob for the embedded 4x4 double miMATRIX
payloads (dims tag [4,4], then 128 bytes of miDOUBLE).  The affine3d
objects are the only 4x4 doubles in the workspace, serialized in result
order, and each matrix found must have the affine tail [0,0,0,1]'.

affine3d stores the row-vector convention ([x y z 1] * T); the matrices
returned here are transposed to the column-vector convention of this
package, H @ [x y z 1]'.  The stored transform is `tf_inv(R, T)` of the
final align state (rkhs_se3_registration.m:261), the quantity `align()`
returns.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_DIMS_4X4 = bytes.fromhex("0500000008000000040000000400000000")[:16]
_MIDOUBLE_128 = bytes.fromhex("0900000080000000")


@dataclass(frozen=True)
class StoredRun:
    """A parsed rgbddataset_rkhs.m result file."""

    transforms: np.ndarray        # [F,4,4] column-vector convention; [0]=I
    registration_time: np.ndarray  # [F-1] seconds per pair (NaN = failed)
    dataset_name: str

    @property
    def num_pairs(self) -> int:
        return self.transforms.shape[0] - 1

    def pair_transform(self, i: int) -> np.ndarray:
        """Transform registered for pair (frame i, frame i+1), 0-based
        (rgbddataset_rkhs.m:46-81 stores it in result{i+1}, 1-based,
        with result{1} = identity)."""
        return self.transforms[i + 1]


def _scan_4x4_doubles(blob: bytes) -> list[np.ndarray]:
    mats = []
    start = 0
    while True:
        i = blob.find(_DIMS_4X4, start)
        if i < 0:
            break
        start = i + 4
        # after the 16-byte dims element: the (empty) array-name element,
        # then the miDOUBLE data tag of the 16 float64 values
        window = blob[i + 16 : i + 40]
        k = window.find(_MIDOUBLE_128)
        if k < 0:
            continue
        off = i + 16 + k + 8
        t = np.frombuffer(blob, dtype="<f8", count=16, offset=off)
        mats.append(t.reshape(4, 4, order="F"))
    return mats


def read_stored_run(path: str) -> StoredRun:
    """Parse a rgbddataset_rkhs.m output .mat with its MCOS transforms."""
    import scipy.io as sio

    m = sio.loadmat(path)
    reg_time = np.asarray(m["registration_time"], dtype=np.float64).ravel()
    name = str(np.asarray(m["dataset_name"]).ravel()[0])
    n_results = int(m["result"].shape[0])

    mats = _scan_4x4_doubles(m["__function_workspace__"].tobytes())
    if len(mats) != n_results:
        raise ValueError(
            f"{path}: found {len(mats)} embedded 4x4 doubles, expected "
            f"{n_results} affine3d results"
        )
    tfs = np.stack([t.T for t in mats])  # row-vector -> column-vector
    if not np.allclose(tfs[:, 3, :], np.array([0.0, 0.0, 0.0, 1.0])):
        raise ValueError(f"{path}: extracted matrices are not affine")
    return StoredRun(
        transforms=tfs, registration_time=reg_time, dataset_name=name
    )
