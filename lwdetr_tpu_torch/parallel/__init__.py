"""Multi-process training and eval: process start, collectives, DDP and ZeRO-1."""
