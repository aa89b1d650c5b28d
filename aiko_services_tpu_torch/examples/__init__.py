# The repo's Python examples on the port: each module is the port's copy
# of the example of the same name under examples/, with the same
# behaviour and flags, run as
#
#   python -m aiko_services_tpu_torch.examples.<folder>.<name> [flags]
#
# They run on the host only (the control plane and the memory
# transport) and take no device.
