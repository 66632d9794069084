"""The port's data pipeline against the JAX package's: synthetic batches
bit-equal for several (seed, step, host_id), a step past 2^20 included;
mmap batches bit-equal on a token file the test writes; the prefetch
iterator's order after a start step; and JAX's determinism and host-
sharding test, ported."""

import numpy as np
import pytest

from repro.data import pipeline as JP
from repro_torch.data import pipeline as TP
from test_torch_train_common import few_threads  # noqa: F401


def _cfgs(**kw):
    return JP.DataConfig(**kw), TP.DataConfig(**kw)


@pytest.mark.parametrize("seed,step,host_id,n_hosts", [
    (0, 0, 0, 1), (0, 1, 0, 1), (9, 5, 1, 2), (123, 777, 3, 4),
    (7, 2 ** 20, 0, 1), (2 ** 31 - 1, 2 ** 20 + 3, 1, 2)])
def test_synthetic_batch_is_bit_equal(seed, step, host_id, n_hosts):
    j, t = _cfgs(vocab=512, seq_len=24, global_batch=8, n_hosts=n_hosts,
                 host_id=host_id, seed=seed)
    want, got = JP._synthetic_batch(j, step), TP._synthetic_batch(t, step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_mmap_batch_is_bit_equal(tmp_path):
    path = tmp_path / "tokens.bin"
    rng = np.random.default_rng(4)
    rng.integers(0, 1000, 5000).astype(np.int32).tofile(path)
    j, t = _cfgs(vocab=1000, seq_len=16, global_batch=4, n_hosts=2,
                 host_id=1, kind="mmap", path=str(path))
    data = np.memmap(path, dtype=np.int32, mode="r")
    for step in (0, 1, 40, 1000):     # 1000 wraps around the file
        want = JP._mmap_batch(j, step, data)
        got = TP._mmap_batch(t, step, data)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    it = TP.DataIterator(t, start_step=3)
    try:
        np.testing.assert_array_equal(next(it)["tokens"],
                                      JP._mmap_batch(j, 3, data)["tokens"])
    finally:
        it.close()


def test_iterator_order_after_a_start_step():
    cfg = TP.DataConfig(vocab=256, seq_len=8, global_batch=2, seed=3)
    it = TP.DataIterator(cfg, start_step=7)
    try:
        for k in range(7, 12):
            b = next(it)
            np.testing.assert_array_equal(
                b["tokens"], TP._synthetic_batch(cfg, k)["tokens"])
            assert it.step == k + 1
    finally:
        it.close()


def test_data_pipeline_determinism_and_host_sharding():
    cfg = TP.DataConfig(vocab=512, seq_len=16, global_batch=8, n_hosts=2,
                        host_id=0, seed=9)
    it = TP.DataIterator(cfg)
    b1 = it.batch_at(5)
    b2 = it.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    it.close()
    other = TP.DataIterator(TP.DataConfig(vocab=512, seq_len=16,
                                          global_batch=8, n_hosts=2,
                                          host_id=1, seed=9))
    b3 = other.batch_at(5)
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    assert b1["tokens"].shape == (4, 16)  # host batch = global/2
    other.close()


def test_labels_are_the_next_tokens():
    cfg = TP.DataConfig(vocab=100, seq_len=12, global_batch=3)
    b = TP._synthetic_batch(cfg, 2)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
