"""B-spline interpolation, FFD, similarity and the registration entry point."""
