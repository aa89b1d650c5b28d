# The video ↔ images pipeline scripts (examples/pipeline/) on the port.
