"""What the benchmark measures against: FLOP counts, per-op work and the
cards' peaks, frozen here so that changes to the port cannot move them."""
