"""Training datasets and the batcher.

Port of ``dpvo_tpu/data/factory.py``: ``SyntheticClipDataset`` renders
procedural multi-plane clips (``utils/synthetic.MultiPlaneScene``) from a
seed, ``dataset_factory`` builds it or the TartanAir reader
(``data/tartan.py``), and ``batch_iterator`` augments and batches clips on
a background thread, optionally from a reservoir of the newest clips.
"""

from __future__ import annotations

import collections
import queue as _queue
import threading
from typing import Iterator

import numpy as np

from dpvo_tpu_torch.data.augmentation import augment_clip
from dpvo_tpu_torch.data.tartan import TartanAirDataset
from dpvo_tpu_torch.utils.synthetic import MultiPlaneScene


class SyntheticClipDataset:
    """Procedural clips (textured-plane scenes): the same clips as the JAX
    package's for the same seed."""

    def __init__(self, n_frames=8, ht=128, wd=160, seed=0,
                 flow_t=(2.0, 28.0), flow_r=(0.5, 8.0)):
        self.n_frames = n_frames
        self.ht, self.wd = ht, wd
        self.rng = np.random.default_rng(seed)
        # target per-frame optical-flow ranges in px at (ht, wd)
        self.flow_t = flow_t
        self.flow_r = flow_r

    def sample(self):
        """(images [F,H,W,3] f32, poses [F,7], disps [F,H,W] f32, intrinsics [4])."""
        seed = int(self.rng.integers(1 << 30))
        # a target full-resolution flow per frame sets the twist scales
        depth = float(self.rng.uniform(5.0, 12.0))
        fx = 0.8 * self.wd
        flow_t = float(self.rng.uniform(*self.flow_t))  # translational px/frame
        flow_r = float(self.rng.uniform(*self.flow_r))  # rotational px/frame
        scene = MultiPlaneScene(
            ht=self.ht, wd=self.wd, n_frames=self.n_frames,
            depth=depth, seed=seed,
            # the scene's momentum random walk amplifies the realized flow
            # ~3x over the naive step -> flow map
            tstep=flow_t * depth / fx / 3.0,
            rstep=flow_r / fx / 3.0,
        )
        images = np.stack([scene.render(t) for t in range(self.n_frames)]).astype(np.float32)
        ys, xs = np.mgrid[0 : self.ht, 0 : self.wd]
        disps = np.stack(
            [scene.inv_depth(t, xs.astype(np.float64), ys.astype(np.float64))
             for t in range(self.n_frames)]
        ).astype(np.float32)
        return images, scene.poses.copy(), disps, scene.intrinsics.copy()


def dataset_factory(names, datapath="datasets/TartanAir", n_frames=15, ht=None, wd=None, seed=0,
                    **synth_kw):
    """The TartanAir reader for ``"tartan"`` in names; when datapath holds no
    scene, a warning and synthetic clips, as the JAX factory does."""
    if "tartan" in names:
        ds = TartanAirDataset(datapath, n_frames=n_frames, seed=seed)
        if ds.scenes:
            return ds
        print(f"warning: no TartanAir scenes under {datapath}; using synthetic clips")
    return SyntheticClipDataset(n_frames=n_frames, ht=ht or 128, wd=wd or 160, seed=seed,
                                **synth_kw)


def batch_iterator(dataset, batch_size: int = 1, augment: bool = True, seed: int = 0,
                   prefetch: int = 2, reservoir: int = 0) -> Iterator[dict]:
    """Batches from a background thread: dict(images [B,F,H,W,3] uint8,
    poses [B,F,7] f32, disps [B,F,H,W] f16, intrinsics [B,4] f32).
    ``reservoir`` > 0 samples each batch with replacement from a pool of
    the newest ``reservoir`` clips that a producer thread keeps refreshing,
    so a slow host does not starve the device."""
    rng = np.random.default_rng(seed)

    def make_clip():
        im, po, ds, it = dataset.sample()
        if augment:
            im, ds, it = augment_clip(im, ds, it, rng, out_hw=ds.shape[1:3])
        return (np.clip(im, 0, 255).astype(np.uint8), po.astype(np.float32),
                ds.astype(np.float16), it.astype(np.float32))

    def pack(clips):
        return {
            "images": np.stack([c[0] for c in clips]),
            "poses": np.stack([c[1] for c in clips]),
            "disps": np.stack([c[2] for c in clips]),
            "intrinsics": np.stack([c[3] for c in clips]),
        }

    if reservoir > 0:
        pool = collections.deque(maxlen=reservoir)
        lock = threading.Lock()
        warm = threading.Event()

        def refresh():
            while True:
                c = make_clip()
                with lock:
                    pool.append(c)
                    if len(pool) >= min(4, reservoir):
                        warm.set()

        threading.Thread(target=refresh, daemon=True).start()
        warm.wait()
        while True:
            with lock:
                picks = [pool[rng.integers(len(pool))] for _ in range(batch_size)]
            yield pack(picks)

    q: _queue.Queue = _queue.Queue(maxsize=prefetch)

    def produce():
        while True:
            q.put(pack([make_clip() for _ in range(batch_size)]))

    threading.Thread(target=produce, daemon=True).start()
    while True:
        yield q.get()
