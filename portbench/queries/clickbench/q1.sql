SELECT COUNT(*) AS c FROM hits WHERE "AdvEngineID" <> 0
