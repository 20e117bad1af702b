"""What every cell of the benchmark shares: the cell's files found by name
(``cells``), the synthetic frames (``scene``), the run (``session``), the
comparison with the reference (``judge``), the profile's reading
(``trace``), percentiles (``stats``), the card's peaks and the SOR byte
counts (``peaks``) and the card's checks (``card``)."""
