"""Model families beside the detectors: Segment Anything (`sam/`) and
FastSAM's prompt selection (`fastsam.py`)."""
