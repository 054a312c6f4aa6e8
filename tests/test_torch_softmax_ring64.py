"""``tests/test_torch_softmax.py``'s tournaments along axis 1 of size
10 and 5 at ring64 fixed(8,17), under both threefry streams: every share
word for word the JAX package's, the revealed results held to numpy.
Ring64's eager kernels share no compile with ring128's, so these run in
a file of their own, on another test worker."""

import pytest

from test_torch_softmax import PRECISIONS, STREAMS, check_tournaments


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("width,integ,frac", PRECISIONS[1:])
@pytest.mark.parametrize("n,axis", ((10, 1), (5, 1)))
def test_tournaments_match(stream, width, integ, frac, n, axis):
    check_tournaments(stream, width, integ, frac, n, axis)
