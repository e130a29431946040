SELECT "TraficSourceID", "SearchEngineID", "AdvEngineID", COUNT(*) AS c
FROM hits WHERE "IsRefresh" = 0
GROUP BY "TraficSourceID", "SearchEngineID", "AdvEngineID"
ORDER BY c DESC LIMIT 10
