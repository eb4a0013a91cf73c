"""Box algebra, receptive-field mapping, anchors and mask compaction."""
