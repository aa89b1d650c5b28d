# Observability the port keeps its own copy of (the batching metrics).
