"""Plain PyTorch references of what the benchmark's cells compute.  They
import nothing of the program and take only the benchmark's own tables."""
