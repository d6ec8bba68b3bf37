"""CIFAR-10, ImageNet and language-model input pipelines in numpy, images
NCHW (PyTorch port of the CIFAR, synthetic-ImageNet and LM-corpus parts of
``distributed_kfac_pytorch_tpu/training/datasets.py``).

Real CIFAR-10 is read from python pickle batches when present; otherwise
a deterministic synthetic set of the same shapes (the JAX package's
class-conditional Gaussian images, same values, transposed to NCHW)
keeps every run offline; the LM corpus likewise (whitespace-tokenized
``train.txt`` / ``valid.txt``, else the JAX package's synthetic Markov
chain, token for token). ImageNet is synthetic only: the JAX package's
tf.data directory reader is not ported. Augmentation draws its random
numbers in the JAX package's order, so both packages crop and flip
alike. ``epoch_batches`` and ``bptt_batches`` take ``skip_batches`` for
mid-epoch resume as the JAX functions do: the rest of the epoch equals the
uninterrupted epoch's batches, crops and flips included.
"""

from __future__ import annotations

import functools
import os
import pickle
from typing import Iterator

import numpy as np

CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.247, 0.243, 0.262], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

CIFAR_SEARCH_PATHS = (
    'data/cifar-10-batches-py',
    '/data/cifar-10-batches-py',
    os.path.expanduser('~/data/cifar-10-batches-py'),
)


def _load_cifar_pickles(root: str):
    xs, ys = [], []
    for name in [f'data_batch_{i}' for i in range(1, 6)]:
        with open(os.path.join(root, name), 'rb') as f:
            d = pickle.load(f, encoding='bytes')
        xs.append(d[b'data'])
        ys.extend(d[b'labels'])
    with open(os.path.join(root, 'test_batch'), 'rb') as f:
        d = pickle.load(f, encoding='bytes')

    def to_nchw(flat):
        return flat.reshape(-1, 3, 32, 32).astype(np.float32) / 255.0

    return ((to_nchw(np.concatenate(xs)), np.array(ys, np.int64)),
            (to_nchw(d[b'data']), np.array(d[b'labels'], np.int64)))


@functools.lru_cache(maxsize=2)
def _prototypes(n_classes: int, hw: int) -> np.ndarray:
    """The class prototypes every split draws from (a fixed seed), made
    once per process and shape and read-only: at ImageNet's 1000 classes
    and 224 px they are 150 M normal draws, seconds of host time that each
    split and each run in a process would otherwise repeat."""
    protos = np.random.default_rng(1234).normal(
        size=(n_classes, hw, hw, 3)).astype(np.float32)
    protos.setflags(write=False)
    return protos


def _synthetic_images(n: int, hw: int, n_classes: int, seed: int):
    """Deterministic class-conditional Gaussian images (learnable), NCHW.

    The class prototypes come from a fixed seed shared by every split
    (:func:`_prototypes`); ``seed`` varies the labels and the noise.
    """
    protos = _prototypes(n_classes, hw)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = 0.5 * protos[labels]
    x += rng.normal(scale=0.5, size=x.shape).astype(np.float32)
    return (np.ascontiguousarray(x.astype(np.float32).transpose(0, 3, 1, 2)),
            labels.astype(np.int64))


def get_cifar(data_dir: str | None = None, synthetic_size: int = 2048):
    """((train_x, train_y), (test_x, test_y)) normalized NCHW CIFAR-10.

    Reads pickle batches from ``data_dir`` or the standard search paths;
    falls back to a synthetic set (``synthetic_size`` train / 1/4 test).
    ``KFAC_SYNTHETIC_CIFAR`` overrides the synthetic size.
    """
    env_size = os.environ.get('KFAC_SYNTHETIC_CIFAR')
    if env_size:
        synthetic_size = int(env_size)
    roots = [data_dir] if data_dir else []
    roots += list(CIFAR_SEARCH_PATHS)
    for root in roots:
        if root and os.path.isfile(os.path.join(root, 'data_batch_1')):
            train, test = _load_cifar_pickles(root)
            break
    else:
        train = _synthetic_images(synthetic_size, 32, 10, seed=0)
        test = _synthetic_images(synthetic_size // 4, 32, 10, seed=1)
    mean = CIFAR_MEAN[None, :, None, None]
    std = CIFAR_STD[None, :, None, None]
    norm = lambda x: ((x - mean) / std).astype(np.float32)  # noqa: E731
    return (norm(train[0]), train[1]), (norm(test[0]), test[1])


def get_imagenet(data_dir: str | None = None, image_size: int = 224,
                 synthetic_size: int = 512, num_classes: int = 1000):
    """((train_x, train_y), (val_x, val_y)) normalized NCHW synthetic
    ImageNet: ``synthetic_size`` images per split at ``image_size``, the
    JAX package's arrays from the same seeds. A ``data_dir`` holding a
    ``train`` tree raises: the tf.data reader is not ported."""
    if data_dir and os.path.isdir(os.path.join(data_dir, 'train')):
        raise NotImplementedError(
            'the ImageNet directory reader (tf.data in the JAX package) is '
            'not ported yet; run without --data-dir for synthetic data')
    train = _synthetic_images(synthetic_size, image_size, num_classes,
                              seed=0)
    val = _synthetic_images(synthetic_size, image_size, num_classes, seed=1)
    mean = IMAGENET_MEAN[None, :, None, None]
    std = IMAGENET_STD[None, :, None, None]
    norm = lambda x: ((x - mean) / std).astype(np.float32)  # noqa: E731
    return (norm(train[0]), train[1]), (norm(val[0]), val[1])


def consume_augment_rng(rng: np.random.Generator, n: int) -> None:
    """Advance ``rng`` exactly as :func:`augment_cifar` would for a batch
    of ``n`` images, without the pixel work (a skipped batch of a resumed
    epoch). Must mirror ``augment_cifar``'s draws: crop ys, crop xs,
    flip."""
    rng.integers(0, 9, size=n)
    rng.integers(0, 9, size=n)
    rng.random(n)


def augment_cifar(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Pad-4 (reflect) random crop + horizontal flip of an NCHW batch;
    its draws are mirrored by :func:`consume_augment_rng`."""
    n, c, h, w = x.shape
    ys = rng.integers(0, 9, size=n)
    xs = rng.integers(0, 9, size=n)
    flip = rng.random(n) < 0.5
    padded = np.pad(x, ((0, 0), (0, 0), (4, 4), (4, 4)), mode='reflect')
    out = np.empty_like(x)
    for i in range(n):
        img = padded[i, :, ys[i]:ys[i] + h, xs[i]:xs[i] + w]
        out[i] = img[:, :, ::-1] if flip[i] else img
    return out


def epoch_batches(x: np.ndarray, y: np.ndarray, batch_size: int, *,
                  shuffle: bool = True, seed: int = 0, epoch: int = 0,
                  augment: bool = False, skip_batches: int = 0
                  ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Full batches, reshuffled per epoch from ``(seed, epoch)`` (the
    trailing partial batch is dropped). ``skip_batches`` drops the first
    batches for mid-epoch resume: they are not built, but their
    augmentation draws are consumed, so the batches that remain equal the
    uninterrupted epoch's."""
    n = x.shape[0]
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    idx = rng.permutation(n) if shuffle else np.arange(n)
    for bi, start in enumerate(range(0, n - n % batch_size, batch_size)):
        sel = idx[start:start + batch_size]
        if bi < skip_batches:
            if augment:
                consume_augment_rng(rng, len(sel))
            continue
        xb = x[sel]
        if augment:
            xb = augment_cifar(xb, rng)
        yield xb, y[sel]


def get_lm_corpus(data_dir: str | None = None, *,
                  synthetic_size: int = 200_000,
                  vocab_size: int = 1000):
    """(train_ids, val_ids, vocab_size) int32 token streams.

    Reads whitespace-tokenized ``train.txt`` / ``valid.txt`` under
    ``data_dir`` (PTB / WikiText layout; newlines become ``<eos>``, the
    vocabulary comes from the train split plus ``<unk>``). Without them,
    a synthetic sparse random bigram chain over ``vocab_size`` tokens
    (``synthetic_size`` train tokens, a tenth as many validation tokens),
    the same ids as the JAX package's for the same arguments.
    ``KFAC_SYNTHETIC_LM`` overrides the synthetic train-token count.
    """
    env_size = os.environ.get('KFAC_SYNTHETIC_LM')
    if env_size:
        synthetic_size = max(int(env_size), 10)
    if data_dir and os.path.isfile(os.path.join(data_dir, 'train.txt')):
        def read(split):
            with open(os.path.join(data_dir, f'{split}.txt')) as f:
                return f.read().replace('\n', ' <eos> ').split()
        train_tok = read('train')
        val_tok = read('valid')
        vocab = {w: i for i, w in enumerate(
            sorted(set(train_tok)) + ['<unk>'])}
        unk = vocab['<unk>']

        def to_ids(toks):
            return np.array([vocab.get(w, unk) for w in toks], np.int32)
        return to_ids(train_tok), to_ids(val_tok), len(vocab)

    # Sparse random bigram chain: the next token depends on the current
    # one, so an LM can beat the unigram entropy.
    rng = np.random.default_rng(1234)
    n_next = 8
    trans = rng.integers(0, vocab_size, size=(vocab_size, n_next))

    def gen(n, seed):
        r = np.random.default_rng(seed)
        out = np.empty(n, np.int32)
        tok = 0
        for i in range(n):
            out[i] = tok
            tok = trans[tok, r.integers(0, n_next)]
        return out

    return (gen(synthetic_size, 0), gen(synthetic_size // 10, 1),
            vocab_size)


def bptt_batches(ids: np.ndarray, batch_size: int, bptt: int, *,
                 shuffle_offset: bool = False, seed: int = 0,
                 epoch: int = 0, skip_batches: int = 0
                 ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """``(inputs, targets)`` BPTT windows of shape ``(batch_size, bptt)``.

    The stream is folded into ``batch_size`` contiguous tracks; targets are
    the inputs shifted by one. With ``shuffle_offset`` each ``(seed,
    epoch)`` starts the tracks at a random offset below ``bptt``; a short
    last window is dropped; ``skip_batches`` drops the first windows
    after the offset draw.
    """
    n = ids.shape[0]
    off = 0
    if shuffle_offset and (n - 1) // batch_size > bptt:
        off = int(np.random.default_rng(
            np.random.SeedSequence([seed, epoch])).integers(0, bptt))
    track = (n - 1 - off) // batch_size
    x = ids[off:off + batch_size * track].reshape(batch_size, track)
    t = ids[off + 1:off + 1 + batch_size * track].reshape(batch_size,
                                                          track)
    for bi, start in enumerate(range(0, track - 1, bptt)):
        stop = min(start + bptt, track)
        if stop - start < bptt:
            break
        if bi < skip_batches:
            continue
        yield x[:, start:stop], t[:, start:stop]
