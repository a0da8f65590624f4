"""QueryEngine.stats(): tickets completed over batches dispatched."""


def read(rec):
    serve = rec.get("serve")
    if not serve or not serve["batches"]:
        return None
    return serve["tickets_completed"] / serve["batches"]
