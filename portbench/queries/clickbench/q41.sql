SELECT "WindowClientWidth", "WindowClientHeight", COUNT(*) AS c FROM hits
WHERE "IsRefresh" = 0 AND "DontCountHits" = 0 AND "URLHash" = 123456
GROUP BY "WindowClientWidth", "WindowClientHeight"
ORDER BY c DESC LIMIT 10
