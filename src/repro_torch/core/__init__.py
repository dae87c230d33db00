"""Host-side transform engine of the port: grids, the Legendre oracle, the
phase stage, the serial SHT, the precompute cache and the plans."""
