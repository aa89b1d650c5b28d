# The operator scripts on the port: each module is the port's copy of the
# repo script of the same name under scripts/, with the same scenarios,
# reports, verdicts and exit codes, run as
#
#   python -m aiko_services_tpu_torch.scripts.<name> [options]
#
# The runners that drive a model (chaos_soak's speech and migrate soaks,
# disagg_smoke) take --device, and run on the card unless it names
# another device; the host-only runners take none.
