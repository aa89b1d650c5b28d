# Models of the port: the shared layers and Whisper.
