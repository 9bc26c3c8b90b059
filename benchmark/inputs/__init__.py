"""What a run is fed: the seeded synthetic city and the seeded weights,
made on the run's device."""
