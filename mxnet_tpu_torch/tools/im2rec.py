"""Pack images into a RecordIO file: the port's counterpart of
``tools/im2rec.py``, with its list format, flags and records.

Usage:
  python -m mxnet_tpu_torch.tools.im2rec <list-file> <image-root> <out.rec>
         [--resize N] [--quality Q] [--center-crop]

List file format: one image per line,
  <index>\\t<label>\\t<relative-path>
Multi-label: <index>\\t<l1>\\t<l2>...\\t<path> (label vector).

Or build a list from a directory tree (class per subfolder):
  python -m mxnet_tpu_torch.tools.im2rec --make-list <image-root> <out.lst>

The images go through the port's own codecs and Pillow's resample copied
in ``io/_imaging.py``, so the records are the JAX script's byte for byte
without PIL: PNG and JPEG sources decode as ``Image.open(path).convert(
"RGB")`` does, ``--resize`` is ``Image.resize`` with its default filter
(BICUBIC), and the JPEG records are PIL's bytes, written by PIL where it
can be imported and by the port's native encoder elsewhere. BMP sources
need PIL: without it they raise ``MXNetError`` naming PIL and the file.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..base import MXNetError
from ..io import _imaging
from .. import recordio as rio

_IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp")


def make_list(root: str, out_lst: str):
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    idx = 0
    with open(out_lst, "w") as f:
        for label, cls in enumerate(classes):
            for fname in sorted(os.listdir(os.path.join(root, cls))):
                if fname.lower().endswith(_IMAGE_SUFFIXES):
                    f.write(f"{idx}\t{float(label)}\t{cls}/{fname}\n")
                    idx += 1
    print(f"wrote {idx} entries ({len(classes)} classes) to {out_lst}")


def read_image(path: str) -> np.ndarray:
    """The file at ``path`` as HWC uint8 RGB, as ``np.asarray(Image.open(
    path).convert("RGB"))``: PNG and JPEG through the port's codecs, other
    formats (BMP) through PIL, which must then be importable."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] == _imaging._PNG_SIGNATURE or buf[:2] == _imaging._JPEG_SOI:
        return _imaging.decode(buf)
    Image = _imaging._pil_image()
    if Image is None:
        raise MXNetError(f"im2rec: {path} is neither PNG nor JPEG, and "
                         "reading it needs PIL, which cannot be imported")
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def resize_short(img: np.ndarray, resize: int) -> np.ndarray:
    """The shorter side to ``resize``, as the JAX script's ``img.resize``
    (rounded half up, Pillow's default BICUBIC)."""
    h, w = img.shape[:2]
    s = resize / min(w, h)
    return _imaging.resize(img, (int(w * s + 0.5), int(h * s + 0.5)),
                           _imaging.BICUBIC)


def _center_crop(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    side = min(w, h)
    left, top = (w - side) // 2, (h - side) // 2
    return img[top:top + side, left:left + side]


def pack(list_file: str, root: str, out_rec: str, resize=0, quality=95,
         center_crop=False):
    writer = rio.MXIndexedRecordIO(out_rec + ".idx", out_rec, "w")
    count = 0
    with open(list_file) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            idx = int(parts[0])
            labels = [float(x) for x in parts[1:-1]]
            img = read_image(os.path.join(root, parts[-1]))
            if resize:
                img = resize_short(img, resize)
            if center_crop:
                img = _center_crop(img)
            if len(labels) == 1:
                header = rio.IRHeader(0, labels[0], idx, 0)
            else:
                header = rio.IRHeader(len(labels), labels, idx, 0)
            writer.write_idx(idx, rio.pack_img(
                header, np.ascontiguousarray(img), quality=quality,
                img_fmt=".jpg"))
            count += 1
            if count % 1000 == 0:
                print(f"packed {count} images")
    writer.close()
    print(f"wrote {count} records to {out_rec}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("args", nargs="+")
    ap.add_argument("--make-list", action="store_true")
    ap.add_argument("--resize", type=int, default=0)
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--center-crop", action="store_true")
    a = ap.parse_args(argv)
    if a.make_list:
        make_list(a.args[0], a.args[1])
    else:
        pack(a.args[0], a.args[1], a.args[2], resize=a.resize,
             quality=a.quality, center_crop=a.center_crop)


if __name__ == "__main__":
    main()
