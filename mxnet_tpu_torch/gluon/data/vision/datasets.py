"""Vision datasets (counterpart of
mxnet_tpu/gluon/data/vision/datasets.py): MNIST, FashionMNIST, CIFAR10,
CIFAR100, ImageFolderDataset.

They read the standard files already under `root` (the same names and
formats the reference downloads) and raise RuntimeError when they are
absent: nothing is fetched over a network. Images are uint8 NDArrays on
the CPU, so a DataLoader's worker can read them without the card.
`ImageRecordDataset` reads images from a RecordIO file (datasets.py:178).
"""
from __future__ import annotations

import gzip
import os
import struct
import warnings

import numpy as np

from ....context import cpu
from .... import ndarray
from ..dataset import Dataset, RecordFileDataset
from ....recordio import unpack_img

__all__ = ["CIFAR10", "CIFAR100", "FashionMNIST", "ImageFolderDataset",
           "ImageRecordDataset", "MNIST"]


def _host_array(data):
    return ndarray.array(data, ctx=cpu(), dtype=np.uint8)


class _DownloadedDataset(Dataset):
    """Base of the on-disk datasets (datasets.py:43)."""

    def __init__(self, root, transform):
        super().__init__()
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        if not os.path.isdir(self._root):
            os.makedirs(self._root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST digits (datasets.py:70), from the idx files
    (train-images-idx3-ubyte.gz etc., gzipped or not) in `root`."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "mnist"),
                 train=True, transform=None):
        self._train = train
        self._train_data = ("train-images-idx3-ubyte.gz",)
        self._train_label = ("train-labels-idx1-ubyte.gz",)
        self._test_data = ("t10k-images-idx3-ubyte.gz",)
        self._test_label = ("t10k-labels-idx1-ubyte.gz",)
        self._namespace = "mnist"
        super().__init__(root, transform)

    def _get_data(self):
        if self._train:
            data_file, label_file = self._train_data[0], self._train_label[0]
        else:
            data_file, label_file = self._test_data[0], self._test_label[0]
        data_path = os.path.join(self._root, data_file)
        label_path = os.path.join(self._root, label_file)
        for p in (data_path, label_path):
            if not os.path.exists(p) and not os.path.exists(p[:-3]):
                raise RuntimeError(
                    "%s not found. This environment has no network egress; "
                    "place the standard MNIST files under %s." % (
                        p, self._root))

        def _open(path):
            if os.path.exists(path):
                return gzip.open(path, "rb")
            return open(path[:-3], "rb")

        with _open(label_path) as fin:
            struct.unpack(">II", fin.read(8))
            label = np.frombuffer(fin.read(), dtype=np.uint8) \
                .astype(np.int32)
        with _open(data_path) as fin:
            struct.unpack(">IIII", fin.read(16))
            data = np.frombuffer(fin.read(), dtype=np.uint8)
            data = data.reshape(len(label), 28, 28, 1)
        self._label = label
        self._data = _host_array(data)


class FashionMNIST(MNIST):
    """Fashion-MNIST (datasets.py:123), in MNIST's files and format."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root=root, train=train, transform=transform)
        self._namespace = "fashion-mnist"


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 (datasets.py:171), from the binary batches
    (data_batch_1.bin ... test_batch.bin) in `root` or in its
    cifar-10-batches-bin/."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        self._train = train
        self._archive_file_name = "cifar-10-binary.tar.gz"
        self._train_data = ["data_batch_%d.bin" % i for i in range(1, 6)]
        self._test_data = ["test_batch.bin"]
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = np.frombuffer(fin.read(), dtype=np.uint8).reshape(
                -1, 3072 + 1)
        return data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0].astype(np.int32)

    def _get_data(self):
        files = self._train_data if self._train else self._test_data
        paths = [os.path.join(self._root, f) for f in files]
        alt = os.path.join(self._root, "cifar-10-batches-bin")
        paths = [p if os.path.exists(p)
                 else os.path.join(alt, os.path.basename(p)) for p in paths]
        for p in paths:
            if not os.path.exists(p):
                raise RuntimeError(
                    "%s not found. This environment has no network egress; "
                    "place the CIFAR-10 binary files under %s." % (
                        p, self._root))
        data, label = zip(*[self._read_batch(p) for p in paths])
        self._data = _host_array(np.concatenate(data))
        self._label = np.concatenate(label)


class CIFAR100(CIFAR10):
    """CIFAR-100 (datasets.py:226): train.bin / test.bin (in `root` or its
    cifar-10-batches-bin/); the coarse label, or the fine one with
    `fine_label`. The JAX class names its files after its base's
    constructor has read CIFAR-10's; this one names them first."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        self._train = train
        self._archive_file_name = "cifar-100-binary.tar.gz"
        self._train_data = ["train.bin"]
        self._test_data = ["test.bin"]
        _DownloadedDataset.__init__(self, root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = np.frombuffer(fin.read(), dtype=np.uint8).reshape(
                -1, 3072 + 2)
        return data[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0 + self._fine_label].astype(np.int32)


class ImageRecordDataset(RecordFileDataset):
    """Images and labels from a RecordIO file (datasets.py:178;
    reference: vision/datasets.py:269): item i is (image, label), the
    image a uint8 HWC NDArray on the CPU decoded with `flag` (1 colour,
    0 grayscale), the label the record header's."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        record = super().__getitem__(idx)
        header, img = unpack_img(record, self._flag)
        img = ndarray.array(img, ctx=cpu())
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """Images stored as root/<class>/<image> (datasets.py:303); labels
    number the class folders in sorted order. Reading an image needs
    PIL."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                warnings.warn("Ignoring %s, which is not a directory."
                              % path, stacklevel=3)
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    warnings.warn("Ignoring %s of type %s. Only support %s"
                                  % (filename, ext, ", ".join(self._exts)))
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        from PIL import Image
        img = np.asarray(Image.open(self.items[idx][0]).convert(
            "RGB" if self._flag else "L"))
        img = _host_array(img)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
