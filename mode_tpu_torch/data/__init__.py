"""Datasets, file listers, preprocessing, the packed fusion frames
(``fusion_pack.py``) and the threaded loader (``mode_tpu/data``). Items and
batches are numpy arrays, channel-minor as the models take them; a CLI moves
each batch to its device in one copy per array."""
