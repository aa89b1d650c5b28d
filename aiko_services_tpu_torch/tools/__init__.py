# The in-program A/B tools on the port: each module is the port's copy of
# the repo tool of the same name under tools/, timing the program the
# decoder or the ASR element really runs (a whole chained step), run as
#
#   python -m aiko_services_tpu_torch.tools.<name> [arguments]
#
# They time on the card (timing.timed_chain brackets chained device work
# with CUDA events); their functions take device="cpu" so that tests can
# run them at a tiny size, where a time means nothing.
