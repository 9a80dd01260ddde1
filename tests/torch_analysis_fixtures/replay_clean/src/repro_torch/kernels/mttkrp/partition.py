"""Clean twin of the replay fixtures: the repo's own replay, re-exported."""

from repro_torch.kernels.mttkrp.partition import (  # noqa: F401
    emulate_split,
    emulate_tiles,
    stream_entries_read,
)
