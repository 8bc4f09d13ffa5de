"""The ``content-import`` control: ``content_address`` made of the
reference, with the window thinning of the candidates left out.

It stands where the port's ``content_address`` stands and cuts at the
first candidate past the minimum size among all candidates, not only
among the first of each aligned ``2^thin_bits``-byte window: the
configuration's chunking is what it breaks, the simplification a change
to the candidate scan would be tempted by.  Digests and root are the
reference's over those cuts.
"""

from __future__ import annotations

import types

from portbench.reference import cdc


def unthinned(state):
    chunking = state.cell.config["chunking"]

    def address(data):
        cuts, digests, root = cdc.summary(data, chunking, state.device,
                                          thinned=False)
        return types.SimpleNamespace(length=len(data), cuts=cuts,
                                     digests=digests, root=root)

    return address


SYSTEMS = {"unthinned": unthinned}
