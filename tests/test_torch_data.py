"""The port's synthetic data pipeline is bit-identical to the reference's:
``batch_at``, ``embeds_batch_at`` and ``host_local_slice``."""

import numpy as np
import pytest

from repro.data.pipeline import SyntheticLMData as JData
from repro.data.pipeline import host_local_slice as jslice
from repro_torch.data.pipeline import SyntheticLMData, host_local_slice


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 16, 2, 0), (128256, 33, 3, 7)])
def test_batches_bit_identical_to_reference(vocab, seq, batch, seed):
    ours, ref = SyntheticLMData(vocab, seq, batch, seed), JData(vocab, seq, batch, seed)
    for step in (0, 1, 5, 1000):
        got, want = ours.batch_at(step), ref.batch_at(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])
        e_got, e_want = ours.embeds_batch_at(step, 24), ref.embeds_batch_at(step, 24)
        for k in e_want:
            np.testing.assert_array_equal(e_got[k], e_want[k])
    assert not np.array_equal(ours.batch_at(0)["tokens"], ours.batch_at(1)["tokens"])


def test_host_local_slice_matches_reference():
    batch = SyntheticLMData(512, 8, 8, 1).batch_at(3)
    for n_hosts in (1, 2, 4):
        for host in range(n_hosts):
            got, want = host_local_slice(batch, host, n_hosts), jslice(batch, host, n_hosts)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="does not split"):
        host_local_slice(batch, 0, 3)
