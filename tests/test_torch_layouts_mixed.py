"""test_torch_layouts.py's test_datapath_matches_jax on the worlds of its
MIXED list: ranges523 (the generic identity branch over a DIR-24-8
ipcache) and the worlds that cross two or three builder thresholds
together.  The case, its world and its checks are that file's; they run
from here so that `--dist loadfile` gives the two halves of the cases to
two workers.
"""

import pytest

import test_torch_layouts as layouts


@pytest.mark.parametrize("name", layouts.MIXED)
def test_datapath_matches_jax(name):
    """Each world's tables take the reference's layouts, leaf for leaf,
    wide and sub-word; then on the sub-word tables, port-built and
    carried across: the pair step, replay()
    and, on the FULL worlds, every single-batch form, column for column,
    with the counters and the telemetry exact."""
    layouts.check_datapath_matches_jax(name)
