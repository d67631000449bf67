"""Device-side data transforms of the port."""
