"""Traffic generators, one a cell kind, seeded by ``--seed`` only."""
