"""The benchmark's yardstick: manifest, catalog draw, peaks, window clock,
trace reduction, the import guard and the comparisons behind ``correct``."""
