"""Datasets and the input pipeline, port of `pix2pix3d_tpu/train/dataset.py`
(ref `training/dataset.py`; NHWC numpy batches).

`ImageFolderDataset` (directory or zip, poses from `dataset.json`),
`ImageSegFolderDataset` (a parallel mask archive; items
{image, pose, mask, idx}), `ImageEdgeFolderDataset` (the edge map inverted,
3x3 box-blurred and nearest-resized), the rank-sharded shuffling-window
`InfiniteSampler` (ref `misc.py:113-144`), `normalize_batch` (image ->
[-1, 1], edge mask -> -(x/127.5 - 1), seg labels as they are; ref
`training_loop.py:489-493`) and a thread-prefetched `DataLoader`.

PNGs are decoded by the repo's `native/png_reader.cpp`
(`train/native_loader.py`), as the JAX package does when its native library
is built; Pillow is not a dependency of the port.  Other image formats go
through Pillow, imported where such a file is read, and raise where it is
missing.
The file list is every file with an image extension of `IMAGE_EXTENSIONS`.
"""

from __future__ import annotations

import io
import json
import os
import queue
import threading
import zipfile

import numpy as np

from . import native_loader

# the image file extensions a dataset lists (Pillow's common formats)
IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tif", ".tiff",
                    ".webp", ".ppm", ".pgm"}


def _file_ext(fname):
    return os.path.splitext(fname)[1].lower()


class _Archive:
    """Uniform reader over a directory or a zip file."""

    def __init__(self, path):
        self.path = path
        self._zip = None
        if os.path.isdir(path):
            self.type = "dir"
            self.fnames = {
                os.path.relpath(os.path.join(root, f), start=path)
                for root, _d, files in os.walk(path) for f in files}
        elif _file_ext(path) == ".zip":
            self.type = "zip"
            self.fnames = set(self._zipfile().namelist())
        else:
            raise IOError("Path must point to a directory or zip: " + path)

    def _zipfile(self):
        if self._zip is None:
            self._zip = zipfile.ZipFile(self.path)
        return self._zip

    def open(self, fname):
        if self.type == "dir":
            return open(os.path.join(self.path, fname), "rb")
        return self._zipfile().open(fname, "r")

    def close(self):
        if self._zip is not None:
            self._zip.close()
            self._zip = None


def _decode_other(data):
    """A non-PNG image through Pillow -> HWC uint8."""
    import PIL.Image
    return np.array(PIL.Image.open(io.BytesIO(data)))


def _load_image_hwc(f):
    """Decode an image file object -> HWC uint8."""
    data = f.read()
    img = (native_loader.decode_png(data) if data[:4] == b"\x89PNG"
           else _decode_other(data))
    if img.ndim == 2:
        img = img[:, :, np.newaxis]
    return img


def _to_gray(img):
    """HWC uint8 -> HW grayscale as Pillow's `convert("L")` computes it
    (ITU-R 601-2 luma in 16-bit fixed point)."""
    if img.shape[2] == 1:
        return img[:, :, 0]
    if img.shape[2] == 2:  # gray + alpha
        return img[:, :, 0]
    r, g, b = (img[:, :, i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _resize_nearest(img, size):
    """HW uint8 nearest resize to size x size, at Pillow's NEAREST sample
    positions (source index floor((i + 0.5) * in / out))."""
    h, w = img.shape
    ys = np.minimum(((np.arange(size) + 0.5) * h / size).astype(np.int64), h - 1)
    xs = np.minimum(((np.arange(size) + 0.5) * w / size).astype(np.int64), w - 1)
    return img[ys][:, xs]


class Dataset:
    """Base dataset (ref `dataset.py:29-159`)."""

    def __init__(self, name, raw_shape, max_size=None, use_labels=False,
                 xflip=False, random_seed=0):
        self._name = name
        self._raw_shape = list(raw_shape)  # [N, H, W, C]
        self._use_labels = use_labels
        self._raw_labels = None
        self._label_shape = None

        self._raw_idx = np.arange(self._raw_shape[0], dtype=np.int64)
        if max_size is not None and self._raw_idx.size > max_size:
            np.random.RandomState(random_seed).shuffle(self._raw_idx)
            self._raw_idx = np.sort(self._raw_idx[:max_size])

        self._xflip = np.zeros(self._raw_idx.size, dtype=np.uint8)
        if xflip:
            self._raw_idx = np.tile(self._raw_idx, 2)
            self._xflip = np.concatenate([self._xflip, np.ones_like(self._xflip)])

    def _load_raw_image(self, raw_idx):
        raise NotImplementedError

    def _load_raw_labels(self):
        raise NotImplementedError

    def close(self):
        pass

    def _get_raw_labels(self):
        if self._raw_labels is None:
            self._raw_labels = self._load_raw_labels() if self._use_labels else None
            if self._raw_labels is None:
                self._raw_labels = np.zeros([self._raw_shape[0], 0], np.float32)
            if self._raw_labels.shape[0] != self._raw_shape[0]:
                raise ValueError("dataset.json labels do not match the images")
            self._raw_labels_std = self._raw_labels.std(0)
        return self._raw_labels

    def __len__(self):
        return self._raw_idx.size

    def __getitem__(self, idx):
        image = self._load_raw_image(self._raw_idx[idx])
        if self._xflip[idx]:
            image = image[:, ::-1]
        return image.copy(), self.get_label(idx)

    def get_label(self, idx):
        label = self._get_raw_labels()[self._raw_idx[idx]]
        if label.dtype == np.int64:
            onehot = np.zeros(self.label_shape, dtype=np.float32)
            onehot[label] = 1
            label = onehot
        return label.copy()

    def get_label_std(self):
        self._get_raw_labels()
        return self._raw_labels_std

    @property
    def name(self):
        return self._name

    @property
    def image_shape(self):  # [H, W, C]
        return list(self._raw_shape[1:])

    @property
    def num_channels(self):
        return self.image_shape[2]

    @property
    def resolution(self):
        if self.image_shape[0] != self.image_shape[1]:
            raise ValueError("images are not square")
        return self.image_shape[0]

    @property
    def label_shape(self):
        if self._label_shape is None:
            raw = self._get_raw_labels()
            if raw.dtype == np.int64:
                self._label_shape = [int(np.max(raw)) + 1]
            else:
                self._label_shape = list(raw.shape[1:])
        return list(self._label_shape)

    @property
    def label_dim(self):
        if len(self.label_shape) != 1:
            raise ValueError("labels are not vectors")
        return self.label_shape[0]


class ImageFolderDataset(Dataset):
    """Image dataset from a directory or zip with `dataset.json` poses
    (ref `dataset.py:163-243`)."""

    def __init__(self, path, resolution=None, **super_kwargs):
        self._archive = _Archive(path)
        self._image_fnames = sorted(
            f for f in self._archive.fnames if _file_ext(f) in IMAGE_EXTENSIONS)
        if not self._image_fnames:
            raise IOError("No image files found in " + path)
        name = os.path.splitext(os.path.basename(path))[0]
        raw_shape = [len(self._image_fnames)] + list(self._load_raw_image(0).shape)
        if resolution is not None and (raw_shape[1] != resolution
                                       or raw_shape[2] != resolution):
            raise IOError("Image files do not match the specified resolution")
        super().__init__(name=name, raw_shape=raw_shape, **super_kwargs)

    def _load_raw_image(self, raw_idx):
        with self._archive.open(self._image_fnames[raw_idx]) as f:
            return _load_image_hwc(f)

    def _load_raw_labels(self):
        if "dataset.json" not in self._archive.fnames:
            return None
        with self._archive.open("dataset.json") as f:
            labels = json.load(f)["labels"]
        if labels is None:
            return None
        labels = dict(labels)
        labels = np.array([labels[f.replace("\\", "/")] for f in self._image_fnames])
        return labels.astype({1: np.int64, 2: np.float32}[labels.ndim])

    def close(self):
        self._archive.close()


class ImageSegFolderDataset(ImageFolderDataset):
    """Image + parallel segmentation-mask archive (ref `dataset.py:247-386`).
    __getitem__ returns {image uint8 HWC, pose [25], mask HW1, idx}."""

    data_type = "seg"

    def __init__(self, path, mask_path, resolution=None, data_type="seg",
                 **super_kwargs):
        self._mask_archive = _Archive(mask_path)
        self.data_type = data_type
        super().__init__(path, resolution=resolution, **super_kwargs)
        self._mask_fnames = sorted(
            f for f in self._mask_archive.fnames if _file_ext(f) in IMAGE_EXTENSIONS)

    def _load_raw_mask(self, raw_idx):
        with self._mask_archive.open(self._mask_fnames[raw_idx]) as f:
            mask = _load_image_hwc(f)
        return mask[:, :, :1]

    def __getitem__(self, idx):
        raw = self._raw_idx[idx]
        image = self._load_raw_image(raw)
        mask = self._load_raw_mask(raw)
        if self._xflip[idx]:
            image = image[:, ::-1]
            mask = mask[:, ::-1]
        return {"image": image.copy(), "pose": self.get_label(idx),
                "mask": mask.copy(), "idx": idx}

    def close(self):
        super().close()
        self._mask_archive.close()


class ImageEdgeFolderDataset(ImageSegFolderDataset):
    """Edge-conditioned variant (ref `dataset.py:389-518`): grayscale edge
    map inverted + 3x3 box-blurred, nearest-resized to the image res."""

    def __init__(self, path, mask_path, resolution=None, data_type="edge",
                 **super_kwargs):
        super().__init__(path, mask_path, resolution=resolution,
                         data_type=data_type, **super_kwargs)

    def _load_raw_mask(self, raw_idx):
        with self._mask_archive.open(self._mask_fnames[raw_idx]) as f:
            mask = _to_gray(_load_image_hwc(f))
        mask = native_loader.edge_preprocess(mask)
        if mask.shape[0] != self.resolution:
            mask = _resize_nearest(mask, self.resolution)
        return mask[:, :, np.newaxis]


def build_dataset(path, mask_path, data_type="seg", resolution=None, **kwargs):
    cls = {"seg": ImageSegFolderDataset, "edge": ImageEdgeFolderDataset}[data_type]
    return cls(path, mask_path, resolution=resolution, data_type=data_type,
               **kwargs)


class InfiniteSampler:
    """Rank-sharded shuffling-window infinite index stream
    (ref `misc.py:113-144`)."""

    def __init__(self, dataset_size, rank=0, num_replicas=1, shuffle=True,
                 seed=0, window_size=0.5):
        if dataset_size <= 0:
            raise ValueError("empty dataset")
        self.dataset_size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self):
        order = np.arange(self.dataset_size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))
        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield order[i]
            if window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1


def normalize_batch(samples, data_type):
    """Stack samples and normalize like `training_loop.py:489-493` (NHWC)."""
    batch = {
        "image": np.stack([s["image"] for s in samples]).astype(np.float32)
        / 127.5 - 1,
        "pose": np.stack([s["pose"] for s in samples]).astype(np.float32),
        "mask": np.stack([s["mask"] for s in samples]).astype(np.float32),
        "idx": np.array([s["idx"] for s in samples], np.int64),
    }
    if data_type == "edge":
        batch["mask"] = -(batch["mask"] / 127.5 - 1)
    return batch


class DataLoader:
    """Thread-prefetched infinite batch iterator.  A failure in the worker
    thread is raised by the next `next()`; `close()` stops the thread.

    `rows=(start, stop)`: each batch of `batch_size` indices is drawn in
    full, and only its rows [start, stop) are read and yielded (a
    data-parallel rank's share of the global batch; the first batch in full
    with `full_first`, for the snapshot grid)."""

    def __init__(self, dataset, batch_size, rank=0, num_replicas=1, seed=0,
                 prefetch=4, rows=None, full_first=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rows = (0, batch_size) if rows is None else rows
        self.full_first = full_first
        self.sampler = InfiniteSampler(len(dataset), rank=rank,
                                       num_replicas=num_replicas, seed=seed)
        self._queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        it = iter(self.sampler)
        rows = (0, self.batch_size) if self.full_first else self.rows
        try:
            while not self._stop.is_set():
                idx = [int(next(it)) for _ in range(self.batch_size)]
                samples = [self.dataset[i] for i in idx[rows[0]:rows[1]]]
                rows = self.rows
                if not self._put(normalize_batch(samples, self.dataset.data_type)):
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
