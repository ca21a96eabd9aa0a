"""Optimizers of the port: AdamW, DMF-Shampoo (the paper's factorizations
as a training feature), gradient compression, LR schedules."""
