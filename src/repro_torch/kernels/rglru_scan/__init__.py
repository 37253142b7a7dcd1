"""RG-LRU linear recurrence h = a·h + g (see ``csrc/rglru_scan.cu``)."""
