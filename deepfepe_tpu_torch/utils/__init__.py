"""Device resolution, kernel builds and weight carry-over."""
