"""``parallel/dryrun.py`` ``dryrun_multirank`` on 2 gloo CPU ranks: the
port's counterpart of ``__graft_entry__.py`` ``dryrun_multichip`` (a
data-parallel step, an EAST step, the hybrid forward, the multi-step
dispatch and a checkpoint round trip, the ranks' states bit-equal after
each)."""

import torch

from tensorflow_ocr_tpu_torch.parallel.dryrun import dryrun_multirank

torch.set_num_threads(1)


def test_dryrun_multirank_on_two_gloo_ranks(capsys):
    dryrun_multirank(2, "gloo", timeout_s=180)
    assert "dryrun_multirank(2, gloo): ok" in capsys.readouterr().out
