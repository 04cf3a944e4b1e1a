"""The 8x8 scanned digits that ``examples/notebooks/simple_bind.py`` and
``examples/adversary/fgsm.py`` load through ``sklearn.datasets.load_digits``,
read from the copy of scikit-learn's ``digits.csv.gz`` beside this module,
so the port's examples need no scikit-learn.

Source: scikit-learn 1.9.0's package data ``sklearn/datasets/data/
digits.csv.gz`` (57,523 bytes, sha256 ``09f66e6d...51e23aa22``), copied
unchanged; scikit-learn is distributed under the BSD 3-Clause licence. The
data are the test set of the UCI "Optical Recognition of Handwritten Digits"
collection (E. Alpaydin, C. Kaynak), 1,797 images of 64 pixels, each 0-16,
with the digit as the last column.
"""

import gzip
import os
from types import SimpleNamespace

import numpy as np

DIGITS_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "digits.csv.gz")


def load_digits():
    """``load_digits()`` as scikit-learn returns it, for the fields the
    examples read: ``data`` (1797 x 64, float64), ``target`` (int) and
    ``images`` (1797 x 8 x 8)."""
    with gzip.open(DIGITS_CSV, "rt") as f:
        table = np.loadtxt(f, delimiter=",")
    target = table[:, -1].astype(int, copy=False)
    data = table[:, :-1]
    return SimpleNamespace(data=data, target=target,
                           images=data.reshape(-1, 8, 8),
                           target_names=np.arange(10))
