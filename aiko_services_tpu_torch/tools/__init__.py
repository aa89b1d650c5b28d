# The repo's tools on the port: each module is the port's copy of the
# repo tool of the same name under tools/, run as
#
#   python -m aiko_services_tpu_torch.tools.<name> [arguments]
#
# The in-program A/B tools (ab_*) and the diagnostics (diag_*,
# train_vocoder_scale) time on the card (timing.timed_chain brackets
# chained device work with CUDA events); their functions take
# device="cpu" so that tests can run them at a tiny size, where a time
# means nothing.  The weight converters (convert_*) and the mailbox
# baseline (measure_reference_baseline) run on the host.
