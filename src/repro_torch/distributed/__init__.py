"""Device contexts for the distributed PH pipeline."""
