SELECT "AdvEngineID", COUNT(*) AS c FROM hits WHERE "AdvEngineID" <> 0
GROUP BY "AdvEngineID" ORDER BY c DESC
