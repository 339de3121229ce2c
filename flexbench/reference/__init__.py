"""Plain fp32 PyTorch references of the benchmark's configurations.  They
import nothing of the program; a configuration file names its module."""
