"""Volume files: the sorted needle map behind `.ecx`, and an append-only
`.dat`/`.idx` writer."""
