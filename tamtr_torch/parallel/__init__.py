"""Multi-GPU training: process groups and the data-parallel context
(`dist.py`), and the sequence-parallel scans (`seq_scan.py`)."""
