# Timer storage for the event engine (state/wheel.py).
