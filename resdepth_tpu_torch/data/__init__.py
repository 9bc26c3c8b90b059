"""TileDataset, normalization and control files (host), batch assembly on
the device."""
