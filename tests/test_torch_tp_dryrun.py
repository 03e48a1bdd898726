"""`shmgan_tpu_torch.parallel.dryrun.dryrun_multichip(4)`, the port's
counterpart of the JAX package's `dryrun_multichip`: 4 gloo CPU ranks run a
2 x 2 mesh (tp_min_channels 64) and then pure data parallelism over 4, one
step each at 32 px, filter 16; both print a line ending in OK, the first
with parameters cut over the model axis, the second with none."""

import re

from shmgan_tpu_torch.parallel.dryrun import dryrun_multichip


def test_dryrun_multichip_four_ranks():
    lines = dryrun_multichip(4, timeout=300)
    assert len(lines) == 2 and all(line.endswith("ranks agree OK") for line in lines)
    assert "mesh={'data': 2, 'model': 2} (dp x tp)" in lines[0]
    assert "mesh={'data': 4, 'model': 1} (pure dp)" in lines[1]
    cuts = [[int(c) for c in re.findall(r"cut/whole (\d+)/", line)] for line in lines]
    assert all(c > 0 for c in cuts[0]) and cuts[1] == [0, 0]
