"""WAV-folder datasets and the batch loader with background prefetch.

Port of ``esc_tpu/train/data.py`` (reference: scripts/utils.py:11-46):
``EvalSet`` globs one or two levels of ``*.wav`` (at most 180,000 files) and
drops the last 80 samples of every clip; ``DataLoader`` assembles numpy
batches on host threads ahead of the step. Its order is a pure function of
``(seed, epoch)`` drawn by numpy's generator, and ``quantization_dropout``
draws from a numpy generator too, so the same seed gives the port the data
order and stream counts of the JAX package. On several ranks a loader
counts and orders global batches, as one process does, and each rank reads
the files of its own block of rows (``shard``).
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional

import numpy as np

from ..io import esc_pad_length, load_wav, save_wav, wav_frames

__all__ = ["EvalSet", "DataLoader", "make_dataloader",
           "quantization_dropout", "esc_pad_length", "load_wav", "save_wav",
           "download_data_hf"]


def download_data_hf(repo_id: str = "../dnscustom",
                     filename: str = "testset.tar.gz",
                     local_dir: str = "./data",
                     extract: bool = False) -> str:
    """Fetch a dataset file from the Hugging Face hub (scripts/utils.py:
    93-102) and return its path; with ``extract``, unpack a tarball into
    ``local_dir`` (members outside it refused, ``tarfile``'s ``"data"``
    filter). Needs the ``huggingface_hub`` package, imported here and not
    with the module, and network access; without the package it raises
    ``RuntimeError``: in an offline deployment, put the WAVs under
    ``local_dir`` by hand."""
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise RuntimeError(
            "download_data_hf needs the optional `huggingface_hub` "
            "package (pip install huggingface_hub). In an offline "
            "deployment, place the eval wavs under data/ manually.") from e
    file_path = hf_hub_download(repo_id=repo_id, filename=filename,
                                repo_type="dataset", local_dir=local_dir)
    print(f"File has been downloaded and is located at {file_path}")
    if extract and str(file_path).endswith((".tar.gz", ".tgz", ".tar")):
        import tarfile
        with tarfile.open(file_path) as tf:
            tf.extractall(local_dir, filter="data")
        print(f"Extracted into {local_dir}")
    return file_path


def quantization_dropout(dropout_rate: float, max_streams: int,
                         rng: Optional[np.random.Generator] = None) -> int:
    """The number of streams of one batch (scripts/utils.py:11-25): with
    probability ``dropout_rate`` uniform in 1..max_streams, else all."""
    if not 0 <= dropout_rate <= 1:
        raise ValueError(f"dropout_rate must be within [0, 1], got "
                         f"{dropout_rate}")
    rng = rng or np.random.default_rng()
    if rng.random() < dropout_rate:
        return int(rng.integers(1, max_streams + 1))
    return max_streams


class EvalSet:
    """WAV-folder dataset (scripts/utils.py:27-40)."""

    def __init__(self, folder: str):
        files = sorted(glob.glob(os.path.join(folder, "*.wav")))
        if not files:
            files = sorted(glob.glob(os.path.join(folder, "*", "*.wav")))
        self.files: List[str] = files[:180000]
        if not self.files:
            raise FileNotFoundError(f"no .wav files under {folder}")
        self._max_length: Optional[int] = None

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> np.ndarray:
        return load_wav(self.files[i])[:-80]

    def length(self, i: int) -> int:
        """``len(self[i])``, from the WAV header alone."""
        return max(0, wav_frames(self.files[i]) - 80)

    def max_length(self) -> int:
        """The longest clip after the trim, from the WAV headers: one
        padded length for the whole eval sweep."""
        if self._max_length is None:
            self._max_length = max(wav_frames(f) for f in self.files) - 80
        return self._max_length


class _LoaderError:
    """A worker's exception, carried through the queue to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _Prefetcher:
    """Batches assembled by a thread pool into a bounded queue."""

    def __init__(self, dataset, order, batch_size, num_workers, prefetch=4,
                 pad_to_length=None, drop_last=True, shard=None):
        self.ds, self.order, self.bs = dataset, order, batch_size
        self.pad_to, self.shard = pad_to_length, shard
        self.q: "queue.Queue" = queue.Queue(maxsize=max(2, prefetch))
        if drop_last or pad_to_length is None:
            self.n_batches = len(order) // batch_size
        else:
            self.n_batches = -(-len(order) // batch_size)
        self.workers = max(1, num_workers)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _load_batch(self, idxs):
        if self.pad_to is None and self.shard is not None:
            # this rank's rows, cropped to the global batch's shortest clip
            n = min(self.ds.length(i) for i in idxs)
            return np.stack([self.ds[i][:n] for i in self.shard(idxs)]
                            ).astype(np.float32)
        items = [self.ds[i] for i in idxs]
        if self.pad_to is None:
            # training collate: crop to the shortest clip of the batch
            n = min(len(a) for a in items)
            return np.stack([a[:n] for a in items]).astype(np.float32)
        # eval collate: one padded shape and the true lengths; a short last
        # batch is filled with rows of length 0, which eval_epoch drops
        lengths = np.asarray([len(a) for a in items], dtype=np.int32)
        if lengths.max() > self.pad_to:
            raise ValueError(f"utterance length {lengths.max()} exceeds "
                             f"pad_to_length {self.pad_to}")
        out = np.zeros((self.bs, self.pad_to), dtype=np.float32)
        for b, a in enumerate(items):
            out[b, :len(a)] = a
        if len(items) < self.bs:
            lengths = np.concatenate(
                [lengths, np.zeros(self.bs - len(items), np.int32)])
        return out, lengths

    def _run(self):
        # a worker's exception reaches the consumer, which raises it: a
        # corrupt file fails the epoch instead of ending it early
        try:
            with ThreadPoolExecutor(self.workers) as pool:
                futs = []
                for b in range(self.n_batches):
                    idxs = self.order[b * self.bs:(b + 1) * self.bs]
                    futs.append(pool.submit(self._load_batch, idxs))
                    while len(futs) > self.workers:
                        self.q.put(futs.pop(0).result())
                for f in futs:
                    self.q.put(f.result())
        except BaseException as e:  # noqa: BLE001  (relayed, raised there)
            self.q.put(_LoaderError(e))
        finally:
            self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            if isinstance(item, _LoaderError):
                raise RuntimeError("data loader worker failed") from item.exc
            yield item


class DataLoader:
    """Epoch iterable over an ``EvalSet``. The shuffled order is a pure
    function of ``(seed, epoch)``: a resumed run that calls
    :meth:`set_epoch` sees the order the uninterrupted run saw."""

    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 num_workers: int = 0, seed: int = 0, drop_last: bool = True,
                 pad_to_length: Optional[int] = None,
                 shard: Optional[Callable[[np.ndarray], np.ndarray]] = None):
        self.ds, self.bs, self.shuffle = dataset, batch_size, shuffle
        self.workers, self.seed, self.epoch = num_workers, seed, 0
        self.drop_last, self.pad_to_length = drop_last, pad_to_length
        self.shard = shard

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        if self.drop_last or self.pad_to_length is None:
            return len(self.ds) // self.bs
        return -(-len(self.ds) // self.bs)

    def __iter__(self) -> Iterator[np.ndarray]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
            self.epoch += 1  # for a plain `for epoch in ...` loop
        return iter(_Prefetcher(self.ds, order, self.bs, self.workers,
                                pad_to_length=self.pad_to_length,
                                drop_last=self.drop_last, shard=self.shard))


def make_dataloader(data_path: str, batch_size: int, shuffle: bool,
                    num_workers: int = 0, seed: int = 0,
                    pad_eval: bool = False,
                    pad_fn=esc_pad_length, shard=None) -> DataLoader:
    """Loader over a WAV folder (scripts/utils.py:42-46). ``pad_eval``
    pads every batch to ``pad_fn`` of the longest clip and yields
    ``(audio (B, L), lengths (B,))``, so that clips of unequal length score
    alike at any batch size. ``shard`` (a training loader's) maps the rows
    of a global batch to this rank's
    (:meth:`esc_tpu_torch.parallel.DataParallel.shard`)."""
    ds = EvalSet(data_path)
    pad_to = pad_fn(ds.max_length()) if pad_eval else None
    return DataLoader(ds, batch_size, shuffle, num_workers, seed,
                      drop_last=not pad_eval, pad_to_length=pad_to,
                      shard=shard)
