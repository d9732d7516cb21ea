"""Train-to-serve weight hot-swap -- the reference package's ``publish/``.

The link between the trainer and the serving tier: the trainer publishes
versioned, crc-checksummed weight bundles into a watched directory
(``WeightPublisher``), in the reference's CCWB1 format and leaf layout,
so either package's watcher reads either package's bundles; live
replicas install them between dispatches with no recapture, no dropped
request, and a bitwise A/B guarantee per request (``WeightWatcher``).
The swap needs no recapture because an install ``copy_``s the new
version into the very tensors the CUDA graphs read
(``InferenceEngine.install_weights``), at a dispatch boundary.
"""

from __future__ import annotations

from .bundle import (LATEST, BundleError, bundle_nbytes, leaf_signature,
                     read_bundle, read_latest, read_manifest, write_bundle)
from .publisher import WeightPublisher
from .watcher import WeightWatcher

__all__ = [
    "WeightPublisher", "WeightWatcher", "BundleError",
    "write_bundle", "read_bundle", "read_manifest", "read_latest",
    "leaf_signature", "bundle_nbytes", "LATEST",
]
