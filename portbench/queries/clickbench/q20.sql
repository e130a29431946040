SELECT COUNT(*) AS c FROM hits WHERE "URL" LIKE '%google%'
