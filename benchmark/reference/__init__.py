"""Plain references of the benchmark's models (PyTorch and NumPy only; they
import nothing of the program)."""
