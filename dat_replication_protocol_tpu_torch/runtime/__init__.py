"""Content addressing on top of the device ops."""

from .content import (ContentSummary, content_address, content_digests,
                      delta, reassemble)

__all__ = ["ContentSummary", "content_address", "content_digests", "delta",
           "reassemble"]
